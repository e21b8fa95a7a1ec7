// Device code of K10 contact_select / K10v: the worst-contact selection of
// the collision terms (the reference's max_num_cnt), for one (lane, group)
// at a time.  contact_select.cu runs it a warp per (lane, group);
// contact_select_host.cpp runs the same functions on a CPU, its team of
// threads played in turn.
//
// A group is a step gap of a cast term (S = n_seg segments) or a step of a
// discrete term (S = 1).  Inputs, per lane:
//   D  (G, S, P)        distances (K4 / K4v: (n_gaps, n_seg, P); K7 /
//                       K7v: (span, P))
//   Ja (G, S P, nc)     distance Jacobian rows (K4's Ja; K7's J), row s P + p
//   Jb (G, S P, nc)     K4's second-endpoint rows, or null (discrete)
//   margins, coeffs (P)
// With err = margin - D, a pair's key is its largest err over the group's
// segments.  The K pairs of largest key are kept (key descending, the lower
// index first among equal keys, a NaN key above every number: the order
// of jax.lax.top_k and of a stable descending sort), with all their
// segments:
//   vals (G, S, K)          act ? coeff err : -1,  act = err >= -buffer
//   rows (G, S K, 2 nc)     row s K + k of the banded window: cast
//                           [-Ja sc, -Jb sc]; discrete -J sc in the first
//                           half, or in the second for the group
//                           right_group (step_window's last step), the
//                           other half 0; sc = act ? coeff : 0.
// Every output is one multiply (or a copy) of its inputs, in the plain
// version's order, so the two agree bit for bit where they pick the same
// pairs; the keys are computed alike, so they pick the same pairs.
#pragma once

#ifdef __CUDACC__
#define CS_HD __host__ __device__ __forceinline__
#else
#define CS_HD inline
#endif

namespace csel {

template <typename T>
struct Args {
  const T* D;
  const T* Ja;  // null: K10v (values only)
  const T* Jb;  // null: the discrete form
  const T* margins;
  const T* coeffs;
  T* vals;
  T* rows;  // null: K10v
  int lanes, G, S, P, K, nc, right_group;
  double buffer;
};

// (ka, ia) ranks before (kb, ib); an index < 0 is no candidate
template <typename T>
CS_HD bool before(T ka, int ia, T kb, int ib) {
  if (ib < 0) return ia >= 0;
  if (ia < 0) return false;
  const bool na = ka != ka, nb = kb != kb;
  if (na != nb) return na;
  if (!na && ka != kb) return ka > kb;
  return ia < ib;
}

// the keys of the group's pairs (threads tid, tid + nthr, ...), none
// retired yet
template <typename T>
CS_HD void group_keys(const Args<T>& a, int lane, int g, T* keys, int* ret,
                      int tid, int nthr) {
  const T* Dg = a.D + ((long)lane * a.G + g) * a.S * a.P;
  const T* m = a.margins + (long)lane * a.P;
  for (int p = tid; p < a.P; p += nthr) {
    T key = m[p] - Dg[p];
    for (int s = 1; s < a.S; ++s) {
      const T e = m[p] - Dg[(long)s * a.P + p];
      if (e > key || e != e) key = e;  // max, a NaN kept
    }
    keys[p] = key;
    ret[p] = 0;
  }
}

// thread tid's best pair not yet retired: (key, index), index -1 if none
template <typename T>
CS_HD void local_best(const Args<T>& a, const T* keys, const int* ret,
                      int tid, int nthr, T& bk, int& bi) {
  bk = T(0);
  bi = -1;
  for (int p = tid; p < a.P; p += nthr)
    if (!ret[p] && before(keys[p], p, bk, bi)) {
      bk = keys[p];
      bi = p;
    }
}

// the group's outputs for the K pairs win[0..K) (threads tid, tid + nthr,
// ... of the group's team)
template <typename T>
CS_HD void write_group(const Args<T>& a, int lane, int g, const int* win,
                       int tid, int nthr) {
  const long grp = (long)lane * a.G + g;
  const T* Dg = a.D + grp * a.S * a.P;
  const T* m = a.margins + (long)lane * a.P;
  const T* c = a.coeffs + (long)lane * a.P;
  const T nbuf = -(T)a.buffer;
  T* v = a.vals + grp * a.S * a.K;
  for (int r = tid; r < a.S * a.K; r += nthr) {
    const int s = r / a.K, idx = win[r % a.K];
    const T e = m[idx] - Dg[(long)s * a.P + idx];
    v[r] = e >= nbuf ? c[idx] * e : T(-1);
  }
  if (!a.rows) return;
  const int w = 2 * a.nc;
  const int half_of_discrete = g == a.right_group ? 1 : 0;
  T* out = a.rows + grp * a.S * a.K * w;
  const long jg = grp * a.S * a.P * a.nc;
  for (int q = tid; q < a.S * a.K * w; q += nthr) {
    const int r = q / w, col = q % w;
    const int s = r / a.K, idx = win[r % a.K];
    const int half = col / a.nc, j = col % a.nc;
    const T* J = a.Jb ? (half ? a.Jb : a.Ja) : a.Ja;
    if (!a.Jb && half != half_of_discrete) {
      out[q] = T(0);
      continue;
    }
    const T e = m[idx] - Dg[(long)s * a.P + idx];
    const T sc = e >= nbuf ? c[idx] : T(0);
    out[q] = (-J[jg + ((long)s * a.P + idx) * a.nc + j]) * sc;
  }
}

// shared memory of one team: the keys, the retired flags, the winners
template <typename T>
CS_HD long team_smem_bytes(int P, int K) {
  return (long)P * sizeof(T) + 4L * P + 4L * K;
}

}  // namespace csel
