// The timing build of the fused IVF wave scan: ivf_scan.cu with every phase
// of a step stamped by clock64() (scan_walk.cuh's Phase list), the cycles
// summed per CTA into a (q_tiles, 8) side buffer.  Only the phase-clock
// measurement loads it; the served library is built from ivf_scan.cu alone
// and carries no timing code.
#define IVF_SCAN_CLOCKS 1
#include "ivf_scan.cu"
