// How a block of K7 disc_dist / K7v disc_dist_value divides its work over
// the device functions of collision.cuh.  The same body runs on the card
// (disc_dist.cu) and in the host build (cast_host.cpp), where one thread
// plays the block's threads one after another, phase by phase
// (cast_block.cuh's CB_THREAD / CB_SYNC).
//
// A block holds S (lane, step) slots: slots g0 .. g0 + S - 1 of the
// lanes x span slots in row-major order (g = lane span + step), the last
// block a partial set.  Phases, each over the whole block (CB_SYNC
// between):
//  0  the world's int and real tables staged into shared memory, so that
//     every chain, frame and closed form below reads them there (where
//     they fit beside the S slot records: disc_layout; else every phase
//     reads them from global memory);
//  A  one thread per slot runs the chain at the step's q (S chains at
//     once), then one thread per (slot, dof) joint frame and per (slot,
//     geometry) world record;
//  C  one thread per (pair, slot, column) item, the column fastest, then
//     the slot, the pairs in the world's K7 work list (closed forms
//     grouped by kind pair) taken from its end: a warp runs one pair's
//     closed form over several slots, and the block's last round is its
//     lightest closed form.  Each item is K4's closed form at one slot as
//     a Dual<T, 1> seeded with one dof's point Jacobian (column 0 writes
//     the value), or, past n_dof, a zero.  The slots' D and J rows are
//     contiguous (D (lanes, span, P), J (lanes, span, P, nc)): a block's
//     stores fill one range.
// Each slot's arithmetic is that of one (lane, step) alone, in the same
// order, whatever S and the thread count: the outputs are bitwise equal
// at every layout.
#pragma once

#include "cast_block.cuh"

namespace coll {

// the largest block of K7 / K7v, the shared memory a block may use on the
// card (227 KB), and the largest tables a block stages: staging costs each
// CTA the tables' bytes, and past a few slots' reuse reading them through
// the caches is faster (PERF.md section 6: arm7's 4-7 KB staged, 177 KB
// not)
constexpr int DISC_MAX_THREADS = 256;
constexpr long DISC_MAX_SMEM = 232448;
constexpr long DISC_STAGE_MAX = 48 * 1024;

// byte offsets of a K7 block's shared memory: the int table, the real
// table (when staged), then S slot records (each region 16-byte aligned)
HD long disc_reals_at(int n_ints) {
  return ((long)n_ints * 4 + 15) / 16 * 16;
}
template <typename T>
HD long disc_slots_at(int n_ints, int n_reals, int stage) {
  return stage ? disc_reals_at(n_ints) +
                     ((long)n_reals * (long)sizeof(T) + 15) / 16 * 16
               : 0;
}
template <typename T>
HD long disc_smem_bytes(int n_ints, int n_reals, int S, int stage, int L,
                        int nd, int NG) {
  return disc_slots_at<T>(n_ints, n_reals, stage) +
         (long)S * slot_size_of(L, nd, NG) * (long)sizeof(T);
}

// The block a launch takes within DISC_MAX_SMEM: the tables staged where
// they are at most DISC_STAGE_MAX and fit beside *S slot records; else
// the tables left in global memory and *S lowered to the records that
// fit.  Sets *S and *stage; returns the block's bytes, or -1 where not
// even one slot record fits.
template <typename T>
HD long disc_layout(int n_ints, int n_reals, int L, int nd, int NG, int* S,
                    int* stage) {
  const long slot = (long)slot_size_of(L, nd, NG) * (long)sizeof(T);
  const long tables = disc_slots_at<T>(n_ints, n_reals, 1);
  *stage = tables <= DISC_STAGE_MAX && tables + *S * slot <= DISC_MAX_SMEM;
  const long base = disc_slots_at<T>(n_ints, n_reals, *stage);
  const long fit = (DISC_MAX_SMEM - base) / slot;
  if (fit < 1) return -1;
  if (*S > fit) *S = (int)fit;
  return base + *S * slot;
}

// disc_layout for an element of `esz` bytes (4: float, 8: double): out =
// [S, stage]
HD long disc_layout_of(int esz, int n_ints, int n_reals, int L, int nd,
                       int NG, int S, int* out) {
  out[0] = S;
  return esz == 8 ? disc_layout<double>(n_ints, n_reals, L, nd, NG, out,
                                        out + 1)
                  : disc_layout<float>(n_ints, n_reals, L, nd, NG, out,
                                       out + 1);
}

// One block of K7 disc_dist (JAC) and K7v disc_dist_value: x (lanes,
// x_stride) holds steps of nc columns, the slots' steps are [first,
// first + span) of every lane (n_slots = lanes span in all); D (lanes,
// span, P); J (lanes, span, P, nc), zero past n_dof.  Ig, Fg: the world's
// tables (n_ints, n_reals long), staged into smem where STAGE (a
// template argument, so that the staged block reads them as shared
// memory).  The work list holds the closed-form pairs (a CONVEX side has
// no route here).
template <typename T, bool JAC, bool STAGE>
HD void disc_block(const int* Ig, const T* Fg, int n_ints, int n_reals,
                   const T* x, long x_stride, int nc, int first, int span,
                   long n_slots, T* D, T* J, long block, int S,
                   unsigned char* smem, int nthr) {
  const int* I = Ig;
  const T* F = Fg;
  if constexpr (STAGE) {
    int* Is = reinterpret_cast<int*>(smem);
    T* Fs = reinterpret_cast<T*>(smem + disc_reals_at(n_ints));
    CB_THREAD(t) {
      for (int i = t; i < n_ints; i += nthr) Is[i] = Ig[i];
      for (int i = t; i < n_reals; i += nthr) Fs[i] = Fg[i];
    }
    CB_SYNC();
    I = Is;
    F = Fs;
  }
  T* slots = reinterpret_cast<T*>(smem +
                                  disc_slots_at<T>(n_ints, n_reals, STAGE));
  const int nd = I[1], NG = I[2], P = I[3], sz = slot_size(I);
  const long g0 = block * S;
  const int ns = n_slots - g0 < S ? (int)(n_slots - g0) : S;
  D += g0 * P;
  if constexpr (JAC) J += g0 * P * nc;

  // A: the chain per slot, then the joint frames and world records
  CB_THREAD(t) {
    for (int s = t; s < ns; s += nthr) {
      const long g = g0 + s;
      const T* q = x + (g / span) * x_stride + (first + g % span) * nc;
      slot_chain<T>(I, F, q, q, nullptr, 0, 0, slots + s * sz);
    }
  }
  CB_SYNC();
  CB_THREAD(t) {
    for (int it = t; it < ns * (nd + NG); it += nthr) {
      T* sl = slots + (it / (nd + NG)) * sz;
      const int r = it % (nd + NG);
      if (r < nd)
        slot_frame(I, F, sl, r);
      else
        slot_geom(I, F, sl, r - nd);
    }
  }
  CB_SYNC();

  // C: the (pair, slot, column) items over the whole block, the work
  // list's last kind pair (the heaviest closed form) first
  const int* W = I + I[15];
  const int* Ld = W + 2;
  const int npair = W[0], ncol = JAC ? nc : 1, per = ns * ncol;
  CB_THREAD(t) {
    // item (j, s, c) = j per + s ncol + c, j counted from the list's end;
    // a thread's items step by nthr, its digits (dj, ds, dc) added with
    // their carries
    const int dj = nthr / per, ds = nthr % per / ncol, dc = nthr % ncol;
    int j = t / per, s = t % per / ncol, c = t % ncol;
    for (int it = t; it < npair * per; it += nthr) {
      const int p = Ld[npair - 1 - j];
      T* dt = nullptr;
      if constexpr (JAC) dt = J + ((long)s * P + p) * nc + c;
      if (c < nd)
        discrete_col<T, JAC>(I, F, Slot<T>{I, slots + s * sz},
                             pair_rec(I, p), c, D + s * P + p, dt);
      else if (JAC)  // the columns past n_dof (an inv-dt column)
        *dt = T(0);
      c += dc;
      if (c >= ncol) {
        c -= ncol;
        ++s;
      }
      s += ds;
      if (s >= ns) {
        s -= ns;
        ++j;
      }
      j += dj;
    }
  }
}

}  // namespace coll
