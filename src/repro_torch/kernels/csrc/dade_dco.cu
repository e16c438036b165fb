// Algorithm 1 as a blocked fp32 DCO screen, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/dade_dco.py
// (dade_dco_kernel_call, body _kernel), whose sequential S grid axis carried
// psum, the active mask and the retirement estimate in VMEM scratch.  The
// body is screen_kernel<kFp32Screen> of dco_screen.cuh (design and
// exactness notes there): a pair retires rejected where psum·scale_s >
// (1+ε_s)²r² at a non-final checkpoint, and the survivors retire exact at
// the last one (passed = est <= r²).
//
// Bound on an H100 SXM at the flat screen's shape (1024 x 2^20 x 256, Δd
// 64): the instruction floor, every pair's block-1 sum in dimension order with a
// separate rounded multiply and add, 1.37e11 fp32 instructions, ~4.1 ms;
// the byte floor, three (Q, N) outputs, 12.9 GB, ~3.9 ms at 3.35 TB/s.
// Against the four costs of the 16 x 128 skeleton it replaces: the f32 rows
// stream once (query tile fastest in a linear grid); block 1 runs dense as
// a register-tiled product and its survivors go on as a pair list (dense
// again only over the list's capacity); a 4-deep cp.async ring loads the
// next chunks under this one's products; 12 shared loads per 128 products,
// the block norms summed once per CTA row.
#include "dco_screen.cuh"

DADE_SCREEN_ENTRY(dade_dco, dade::kFp32Screen)
