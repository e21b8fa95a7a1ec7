// K6 ipm_banded in float32 with its phase timer (ipm::Args::clk; the
// design: ipm_banded.cu; the launcher: ipm_launch.cuh): the kernel that
// scripts/ipm_ab.py --phases reads, apart from the one the solver
// launches.

#include "ipm_launch.cuh"

// the timer's instantiations: the block sizes of chip_smoke phase 2d's
// captured QPs (b 7, 8, 9, 14, 21; -1 for another)
extern "C" int ipm_banded_timed_f32(ipm::Args* a, void* stream) {
  if (a->b != 7 && a->b != 8 && a->b != 9 && a->b != 14 && a->b != 21)
    return -1;
  return a->b <= 9 ? launch<float, true, 7, 9>(a, stream)
                   : launch<float, true, 14, 21>(a, stream);
}
