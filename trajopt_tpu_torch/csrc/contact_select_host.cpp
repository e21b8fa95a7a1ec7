// Host build of K10 contact_select / K10v (contact_select.cuh), for
// checking the selection, its tie order included, on a CPU against the
// plain PyTorch version.
//
// The same arguments as contact_select.cu's entry points, with the team
// size in place of the stream: each (lane, group) is run by `team`
// threads played in turn (32: the card's warp).  The route is the card's
// at that team size (reg_route): on the register route each thread's
// Lane steps through the kernel's phases in turn, the warp's reductions
// taken over the team's candidates (team_argmax: the largest image, then
// the least index among its holders) and its shuffles read from the
// sending thread's Lane; on the shared-memory route the arg-max of each
// round is the same butterfly over the threads' candidates as the warp's
// __shfl_xor_sync.  Compiled with a C++ compiler by _native.host_library;
// it is not on any path that solves a problem.

#include <vector>

#include "contact_select.cuh"

using namespace csel;

// __reduce_max_sync over hi (and over lo among the lanes at the maximum,
// float64), then __reduce_min_sync of the index among the lanes at the
// maximum: the round's winner
template <typename T>
static int team_argmax(const unsigned* hi, const unsigned* lo, const int* bi,
                       int n) {
  unsigned hmax = 0u, lmax = 0u, w = 0xffffffffu;
  for (int t = 0; t < n; ++t) hmax = hi[t] > hmax ? hi[t] : hmax;
  if (sizeof(T) == 8)
    for (int t = 0; t < n; ++t)
      if (hi[t] == hmax && lo[t] > lmax) lmax = lo[t];
  for (int t = 0; t < n; ++t) {
    const bool top = hi[t] == hmax && (sizeof(T) == 4 || lo[t] == lmax);
    const unsigned cand = top ? (unsigned)bi[t] : 0xffffffffu;
    w = cand < w ? cand : w;
  }
  return (int)w;
}

// the register route: the team's Lanes through select_regs' phases (a
// shuffle reads the sending Lane's register)
template <typename T, int NP, int NT, int SM>
static void run_regs(const Args<T>& a) {
  std::vector<Lane<T, NP, NT, SM>> L(NT);
  unsigned hi[NT], lo[NT];
  int bi[NT];
  const T nbuf = -(T)a.buffer;
  for (int lane = 0; lane < a.lanes; ++lane)
    for (int g = 0; g < a.G; ++g) {
      const long grp = (long)lane * a.G + g;
      for (int t = 0; t < NT; ++t) {
        L[t].load(a.D + grp * a.S * a.P, a.margins + (long)lane * a.P,
                  a.coeffs + (long)lane * a.P, a.S, a.P, t);
        L[t].plan(a.S, a.K, t);
      }
      for (int k = 0; k < a.K; ++k) {
        for (int t = 0; t < NT; ++t) L[t].best(a.P, t, hi[t], lo[t], bi[t]);
        const int w = team_argmax<T>(hi, lo, bi, NT);
        for (int t = 0; t < NT; ++t) {
          L[t].retire(w, t);
          L[t].note(k, w);
        }
      }
      for (int t = 0; t < NT; ++t)
        L[t].gather(a.S * a.K, a.P, nbuf, [&](int src, int jb, int s) {
          return s < SM ? L[src].e[jb][s] : L[src].c[jb];
        });
      for (int t = 0; t < NT; ++t)
        L[t].write_values(a.vals + grp * a.S * a.K, a.S * a.K, t);
      if (a.rows)
        for (int t = 0; t < NT; ++t)
          L[t].write_rows(a, lane, g, t, [&](int b, int src, int& off, T& sc) {
            off = L[src].roff[b];
            sc = L[src].rsc[b];
          });
    }
}

// the shared-memory route: keys and retired flags in arrays, the rounds'
// butterfly
template <typename T>
static void run_smem(const Args<T>& a, int team) {
  std::vector<T> keys(a.P), bk(team), ok(team);
  std::vector<int> ret(a.P), win(a.K), bi(team), oi(team);
  for (int lane = 0; lane < a.lanes; ++lane)
    for (int g = 0; g < a.G; ++g) {
      for (int t = 0; t < team; ++t)
        group_keys(a, lane, g, keys.data(), ret.data(), t, team);
      for (int k = 0; k < a.K; ++k) {
        for (int t = 0; t < team; ++t)
          local_best(a, keys.data(), ret.data(), t, team, bk[t], bi[t]);
        for (int off = team / 2; off > 0; off >>= 1) {
          ok = bk;
          oi = bi;
          for (int t = 0; t < team; ++t)
            if (before(ok[t ^ off], oi[t ^ off], bk[t], bi[t])) {
              bk[t] = ok[t ^ off];
              bi[t] = oi[t ^ off];
            }
        }
        win[k] = bi[0];
        ret[bi[0]] = 1;
      }
      for (int t = 0; t < team; ++t) write_group(a, lane, g, win.data(), t, team);
    }
}

template <typename T, int NP, int NT>
static void run_regs_s(const Args<T>& a) {
  if (a.S == 1)
    run_regs<T, NP, NT, 1>(a);
  else
    run_regs<T, NP, NT, S_MAX>(a);
}

template <typename T, int NT>
static void run_team(const Args<T>& a) {
  if (!reg_route(a.P, a.S, a.K, NT))
    run_smem(a, NT);
  else if (a.P <= NT)
    run_regs_s<T, 1, NT>(a);
  else
    run_regs_s<T, 2, NT>(a);
}

template <typename T>
static int run(const Args<T>& a, int team) {
  if (a.K < 1 || a.K > a.P || a.S < 1 || (a.Ja && a.nc < 1)) return -1;
  switch (team) {
    case 1: run_team<T, 1>(a); return 0;
    case 2: run_team<T, 2>(a); return 0;
    case 4: run_team<T, 4>(a); return 0;
    case 8: run_team<T, 8>(a); return 0;
    case 16: run_team<T, 16>(a); return 0;
    case 32: run_team<T, 32>(a); return 0;
    default: return -1;
  }
}

#define CS_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* D, const void* Ja, const void* Jb,         \
                      const void* m, const void* c, void* vals, void* rows,  \
                      int lanes, int G, int S, int P, int K, int nc,         \
                      int right_group, double buffer, int team) {            \
    Args<T> a{(const T*)D, (const T*)Ja, (const T*)Jb, (const T*)m,           \
              (const T*)c, (T*)vals, Ja ? (T*)rows : nullptr, lanes, G, S,    \
              P, K, nc, right_group, buffer};                                 \
    return run<T>(a, team);                                                   \
  }

CS_ENTRY(contact_select_f32, float)
CS_ENTRY(contact_select_f64, double)

// 1: the register route at (P, S, K) for a team of `team`, 0: shared memory
extern "C" int contact_select_route(int P, int S, int K, int team) {
  return reg_route(P, S, K, team) ? 1 : 0;
}
