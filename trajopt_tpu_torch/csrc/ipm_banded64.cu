// K6 ipm_banded in float64 (the design: ipm_banded.cu; the launcher:
// ipm_launch.cuh), a source of its own so that nvcc builds it in parallel
// with the float32 one.

#include "ipm_launch.cuh"

extern "C" int ipm_banded_f64(ipm::Args* a, void* stream) {
  return launch<double, false>(a, stream);
}

extern "C" int ipm_banded64_attrs(int which, int* out) {
  return attrs<double>(which, out);
}
