// Algorithm 1 as a blocked fp32 DCO screen, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/dade_dco.py
// (dade_dco_kernel_call, body _kernel), whose sequential S grid axis carried
// psum, the active mask and the retirement estimate in VMEM scratch.  The
// body is screen_kernel<kFp32Screen> of dco_screen.cuh (design, bound and
// exactness notes there): one CTA per 16 x 128 (query, candidate) tile loops
// over the dimension blocks, rejects where psum·scale_s > (1+ε_s)²r² at a
// non-final checkpoint, retires the survivors exact at the last one
// (passed = est <= r²), and stops loading and multiplying once no pair of
// the tile is active.  Bound on an H100 SXM at the flat screen's shape:
// its three (Q, N) outputs, 12.9 GB at 3.35 TB/s.
#include "dco_screen.cuh"

DADE_SCREEN_ENTRY(dade_dco, dade::kFp32Screen)
