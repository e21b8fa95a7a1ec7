// Host build of K10 contact_select / K10v (contact_select.cuh), for
// checking the selection, its tie order included, on a CPU against the
// plain PyTorch version.
//
// The same arguments as contact_select.cu's entry points, with the team
// size in place of the stream: each (lane, group) is run by `team`
// threads played in turn (32: the card's warp), the arg-max of each round
// taken by the same butterfly over the threads' candidates as the warp's
// __shfl_xor_sync.  Compiled with a C++ compiler by _native.host_library;
// it is not on any path that solves a problem.

#include <vector>

#include "contact_select.cuh"

using namespace csel;

template <typename T>
static int run(const Args<T>& a, int team) {
  if (team < 1 || team > 32 || (team & (team - 1)) != 0) return -1;
  if (a.K < 1 || a.K > a.P || a.S < 1 || (a.Ja && a.nc < 1)) return -1;
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
  return 0;
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
