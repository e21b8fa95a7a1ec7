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
//
// Two routes, chosen per launch by the sizes (reg_route):
// - registers (P <= NT NP_MAX, S <= S_MAX, S K <= NT NR at team size NT):
//   lane t holds pairs t, t + NT with their keys, coefficients and S
//   errors (Lane); a round's arg-max is a reduction over the team of an
//   order-preserving image of the keys (key_image), the winner retired by
//   its own lane; lane r % NT keeps row r = s K + k in slot r / NT (its
//   (s, k) planned before the rounds, its pair noted in round k), and
//   after the rounds takes the pair's error s and coefficient from the
//   lane that holds them (one exchange per segment for all rounds) to form
//   the row's value, scale and Jacobian row; the rows then load every
//   Jacobian entry of a batch (NB a lane) before the first store, each
//   entry's row offset and scale taken from the lane that keeps the row;
// - shared memory (every other size the 48 KB of keys allow): the keys
//   and retired flags in shared memory, each round's arg-max a butterfly
//   over the team, the outputs re-read from D (group_keys, local_best,
//   write_group).
#pragma once

#include <cstring>

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

// ---------------------------------------------------------------- registers

constexpr int NP_MAX = 2;  // pairs a lane holds (P <= 64 on the card)
constexpr int S_MAX = 8;   // segments whose errors a lane holds (n_sub <= 9)
constexpr int NR = 2;      // row slots a lane keeps (S K <= 64 on the card)
constexpr int NB = 12;     // row entries a lane loads before it stores

CS_HD bool reg_route(int P, int S, int K, int NT) {
  return P <= NT * NP_MAX && S <= S_MAX && (long)S * K <= (long)NT * NR;
}

// the image of a candidate (key, valid) as two 32-bit words (hi, lo),
// ordered as `before` ranks keys: a NaN above every number, -0 equal to
// +0, equal keys equal images; 0 (no candidate) below every key
template <typename T>
CS_HD void key_image(T k, bool valid, unsigned& hi, unsigned& lo) {
  if (!valid) {
    hi = lo = 0u;
    return;
  }
  if (k != k) {
    hi = lo = 0xffffffffu;
    return;
  }
  if (k == T(0)) k = T(0);
  if constexpr (sizeof(T) == 4) {
    unsigned u;
    memcpy(&u, &k, 4);
    hi = (u >> 31) ? ~u : (u | 0x80000000u);
    lo = 0u;
  } else {
    unsigned long long u;
    memcpy(&u, &k, 8);
    u = (u >> 63) ? ~u : (u | 0x8000000000000000ull);
    hi = (unsigned)(u >> 32);
    lo = (unsigned)u;
  }
}

// one lane of a team of NT holding pairs t + NT j (j < NP) and their
// errors on up to SM segments (SM 1: the discrete form)
template <typename T, int NP, int NT, int SM>
struct Lane {
  T key[NP], c[NP], e[NP][SM];
  unsigned ret;  // bit j: pair t + NT j retired
  int rs[NR], rk[NR];  // the kept rows NT b + t = s K + k (k -1: none)
  int rw[NR];    // kept row's pair: round k's winner
  int roff[NR];  // kept row's Jacobian row s P + pair
  T rsc[NR], rv[NR];  // kept row's scale and value

  // the rows this lane keeps: (s, k) of rows t and NT + t, by compares
  CS_HD void plan(int S, int K, int t) {
#pragma unroll
    for (int b = 0; b < NR; ++b) {
      const int r = NT * b + t;
      int s = 0;
#pragma unroll
      for (int i = 1; i < SM; ++i)
        if (i < S && i * K <= r) s = i;
      rs[b] = s;
      rk[b] = r < S * K ? r - s * K : -1;
      rw[b] = 0;
    }
  }

  // the pairs' errors and keys: every load of D, m and c issued first
  CS_HD void load(const T* __restrict__ Dg, const T* __restrict__ m,
                  const T* __restrict__ cf, int S, int P, int t) {
    T mm[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int p = t + NT * j;
      mm[j] = c[j] = T(0);
#pragma unroll
      for (int s = 0; s < SM; ++s) e[j][s] = T(0);
      if (p < P) {
        mm[j] = m[p];
        c[j] = cf[p];
#pragma unroll
        for (int s = 0; s < SM; ++s)
          if (s < S) e[j][s] = Dg[(long)s * P + p];
      }
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
#pragma unroll
      for (int s = 0; s < SM; ++s)
        if (s < S) e[j][s] = mm[j] - e[j][s];
      T k = e[j][0];
#pragma unroll
      for (int s = 1; s < SM; ++s)
        if (s < S && (e[j][s] > k || e[j][s] != e[j][s])) k = e[j][s];
      key[j] = k;  // max, a NaN kept
    }
    ret = 0u;
  }

  // the lane's best unretired pair: its image and index (-1: none)
  CS_HD void best(int P, int t, unsigned& hi, unsigned& lo, int& bi) const {
    T bk = T(0);
    bi = -1;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int p = t + NT * j;
      if (p < P && !((ret >> j) & 1u) && before(key[j], p, bk, bi)) {
        bk = key[j];
        bi = p;
      }
    }
    key_image(bk, bi >= 0, hi, lo);
  }

  CS_HD void retire(int w, int t) {
    if (w % NT == t) ret |= 1u << (w / NT);
  }

  // round k's winner w: the pair of the rows (s, k) this lane keeps
  CS_HD void note(int k, int w) {
#pragma unroll
    for (int b = 0; b < NR; ++b)
      if (rk[b] == k) rw[b] = w;
  }

  // after the rounds: each kept row's error and coefficient from the
  // lane that holds its pair, then its Jacobian row, scale and value.
  // from(src, j, s) gives e[j][s] (s < SM) or c[j] (s == SM) of lane
  // src; the whole team calls it alike.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
  template <class F>
  CS_HD void gather(int R, int P, T nbuf, F&& from) {
#pragma unroll
    for (int b = 0; b < NR; ++b) {
      if (NT * b >= R) break;  // no lane keeps a row in slot b
      const int src = rw[b] % NT, jb = rw[b] / NT;
      T e = T(0);
#pragma unroll
      for (int s = 0; s < SM; ++s) {
        const T x = from(src, jb, s);
        if (rs[b] == s) e = x;
      }
      const T cv = from(src, jb, SM);
      const bool act = e >= nbuf;
      roff[b] = rs[b] * P + rw[b];
      rsc[b] = act ? cv : T(0);
      rv[b] = act ? cv * e : T(-1);
    }
  }

  // the kept rows' values: row NT b + t
  CS_HD void write_values(T* __restrict__ v, int R, int t) const {
#pragma unroll
    for (int b = 0; b < NR; ++b)
      if (NT * b + t < R) v[NT * b + t] = rv[b];
  }

  // the group's rows (the 2 nc columns of each), slot by slot (rows NT b
  // to NT b + NT - 1), lane t's entries t, t + NT, ... of a slot: a
  // batch's NB Jacobian loads issued before its stores.  fetch(b, src,
  // off, sc) gives the row offset and scale lane src keeps in slot b; the
  // whole team calls it alike.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
  template <class F>
  CS_HD void write_rows(const Args<T>& a, int lane, int g, int t,
                        F&& fetch) const {
    const long grp = (long)lane * a.G + g;
    const int nc = a.nc, w = 2 * nc, R = a.S * a.K;
    const T* __restrict__ Ja = a.Ja;
    const T* __restrict__ Jb = a.Jb;
    const long jg = grp * a.S * a.P * (long)nc;
    T* __restrict__ out = a.rows + grp * (long)R * w;
    const int hd = g == a.right_group ? 1 : 0;
    const int dr = NT / w, dc = NT % w;
#pragma unroll
    for (int b = 0; b < NR; ++b) {
      const int nb = R - NT * b;
      if (nb <= 0) break;
      const int ne = (nb < NT ? nb : NT) * w;
      T* __restrict__ ob = out + (long)NT * b * w;
      for (int base = 0; base < ne; base += NT * NB) {
        int rl = (base + t) / w, col = (base + t) % w;
        T x[NB], sc[NB];
        unsigned live = 0u, zero = 0u;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          // no lane has entries i.. (checked every fourth entry: a check
          // each would chain the entries' shuffles)
          if (i % 4 == 0 && base + NT * i >= ne) break;
          const bool valid = base + t + NT * i < ne;
          int off;
          fetch(b, valid ? rl : 0, off, sc[i]);
          const int half = col >= nc ? 1 : 0, j = col - half * nc;
          x[i] = T(0);
          if (valid) {
            live |= 1u << i;
            if (!Jb && half != hd)
              zero |= 1u << i;
            else
              x[i] = (Jb && half ? Jb : Ja)[jg + (long)off * nc + j];
          }
          col += dc;
          rl += dr;
          if (col >= w) {
            col -= w;
            ++rl;
          }
        }
#pragma unroll
        for (int i = 0; i < NB; ++i)
          if ((live >> i) & 1u)
            ob[base + t + NT * i] =
                ((zero >> i) & 1u) ? T(0) : (-x[i]) * sc[i];
      }
    }
  }
};

// ------------------------------------------------------------ shared memory

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
