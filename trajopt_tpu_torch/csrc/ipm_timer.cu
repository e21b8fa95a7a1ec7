// K6 ipm_banded in float32 with its phase timer (ipm::Args::clk; the
// design: ipm_banded.cu; the launcher: ipm_launch.cuh): the kernel that
// scripts/ipm_ab.py --phases reads, apart from the one the solver
// launches.

#include "ipm_launch.cuh"

extern "C" int ipm_banded_timed_f32(ipm::Args* a, void* stream) {
  return launch<float, true>(a, stream);
}
