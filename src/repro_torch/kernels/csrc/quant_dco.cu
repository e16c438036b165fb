// The int8 lower-bound DCO prefilter with per-dimension scales, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/quant_dco.py
// (quant_dco_kernel_call, body _kernel), which dequantized each block in
// VMEM before its MXU product and carried psum, the active mask and the
// pruned flags across a sequential S grid axis.  The body is
// screen_kernel<kInt8Screen> of dco_screen.cuh (design and exactness notes
// there): a pair retires pruned where max(0, √psum − E(d_s))²(1−slack)·
// scale_s > (1+ε_s)²r², at every checkpoint, the last included; a
// rejection is sound because the bound never exceeds the exact partial
// distance.
//
// Bound on an H100 SXM at the flat screen's shape (1024 x 2^20 x 256, Δd
// 64): the instruction floor, every pair's block-1 sum over the dequantized rows
// in dimension order with a separate rounded multiply and add, 1.37e11
// fp32 instructions, ~4.1 ms; the byte floor, three (Q, N) outputs, 12.9
// GB, ~3.9 ms at 3.35 TB/s.  Against the four costs of the 16 x 128
// skeleton it replaces: the codes stream once, at a byte a dimension
// (query tile fastest in a linear grid), and each is dequantized once per
// CTA (a rounded code·scale[d]) rather than once per query tile; block 1
// runs dense as a register-tiled product and its survivors go on as a pair
// list; a 4-deep cp.async ring loads the next chunks under this one's
// products; 12 shared loads per 128 products, the block norms summed once
// per CTA row.
#include "dco_screen.cuh"

DADE_SCREEN_ENTRY(quant_dco, dade::kInt8Screen)
