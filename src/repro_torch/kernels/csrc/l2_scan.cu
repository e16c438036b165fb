// The FDScanning control: exact squared L2 over the full D, no screening,
// for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/l2_scan.py
// (l2_scan_kernel_call, body _kernel), the same blocked tiling as the DCO
// screen with every (candidate tile, dimension block) computed.  The body
// is screen_kernel<kNoScreen> of dco_screen.cuh: per block it adds
// max(qn + cn − 2 q·c, 0) to the running sum, the block terms summed in
// dimension order with rounded multiplies and adds.  Bound on an H100 SXM
// at 1024 x 2^20 x 256: its 5.5e11 fp32 operations (8.2 ms at 67 TFLOP/s;
// the exact order forbids TF32), against 4.3 GB of output (1.3 ms).
#include "dco_screen.cuh"

DADE_SCREEN_ENTRY(l2_scan, dade::kNoScreen)
