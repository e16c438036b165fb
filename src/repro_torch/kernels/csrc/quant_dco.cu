// The int8 lower-bound DCO prefilter with per-dimension scales, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/quant_dco.py
// (quant_dco_kernel_call, body _kernel), which dequantized each block in
// VMEM before its MXU product and carried psum, the active mask and the
// pruned flags across a sequential S grid axis.  The body is
// screen_kernel<kInt8Screen> of dco_screen.cuh (design, bound and exactness
// notes there): the codes stream at 1 byte a dimension and dequantize as a
// rounded code·scale[d] in shared memory, and a pair retires pruned where
// max(0, √psum − E(d_s))²(1−slack)·scale_s > (1+ε_s)²r², at every
// checkpoint, the last included; a rejection is sound because the bound
// never exceeds the exact partial distance.  Bound on an H100 SXM at the
// flat screen's shape: its three (Q, N) outputs, 12.9 GB at 3.35 TB/s.
#include "dco_screen.cuh"

DADE_SCREEN_ENTRY(quant_dco, dade::kInt8Screen)
