// The producer/consumer pipeline shared by kernels B1 (backpass.cu) and B3
// (fused.cu).
//
// A block owns kLanes batch lanes.  Its warp 0 is the consumer, which
// walks t = N-1 .. 0 and runs riccati.cuh's step on operands it reads from
// shared memory: in B3 thread g < kLanes walks lane g, carrying Vx/Vxx,
// dV, g and the failure flag in registers (consume_tile below); in B1 the
// warp's 32 threads are kLanes groups of four, one a lane, that share each
// step (backpass_coop.cuh).  The other warps are producers: they fill a
// ring of kSlots slots, each holding one time tile (S steps x kLanes
// lanes) of every operand the consumer reads for a (t, lane) -- the
// derivative terms in the packed bundle's component order, then u (Terms
// below).  B1's producer copies the tile from the bundle with cp.async;
// B3's producers compute it (derivs.cuh, one direction pair or box-limit
// evaluation per work item).  A slot is laid out [term][step][lane], lanes
// fastest, so the consumer's reads of one term are free of bank conflicts.
//
// Why: with one thread per lane, a lane's whole work -- B3's derivative
// evaluations, B1's loads -- ran as one dependent chain on one warp per
// SM.  The TPU kernels took their parallelism from 128-lane vectors over
// each step; here the work of a step that does not depend on the carry
// runs on other warps, ahead of the one chain that does.  What is left in
// B3 is the consumer's Riccati step (~2,600 cycles on an H100) times N: B3's
// time at small widths (PERF.md).  B3's consumer runs the one-thread
// kernel's arithmetic (fused.cuh:fused_lane), term for term and in the same
// summation order, so its outputs are bit for bit that kernel's; B1's
// cooperative consumer holds to backpass.cuh:backpass_lane the same way.
// tests/test_torch_dual_host.py holds both compositions against those
// lanes on the host.
//
// Synchronisation: named barriers, two per slot.  Producers wait on slot
// r's "empty" barrier before refilling it and arrive on its "full"
// barrier when done; the consumer waits on "full", runs the tile's steps
// and arrives on "empty".  Producers thus run up to kSlots-1 tiles ahead.
//
// Kernel B2 (rollout.cu) walks time forwards and chains two such rings:
// its input ring is B1's (a cp.async producer warp), and its chain warps
// are in turn the producers of a second ring that the cost warps consume
// (rollout.cuh).  Each ring has its own barrier ids (`base`) and its own
// count of participating threads.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "riccati.cuh"

namespace ddp {

// Tile constants, fixed in the source (timed on an H100 by
// scripts/tile_sweep.py; PERF.md).
constexpr int kLanes = 8;                   // lanes a block owns (G)
constexpr int kSlots = 2;                   // slots in the ring (R)
constexpr int kSlotBudget = 224 * 1024;     // bytes the ring may take

// The terms of one step in a slot: the component order of the packed
// bundle (ops/cuda_backpass.py: _BUNDLE_KEYS; cxx, cuu and the last two
// axes of fxx/fuu as row-major upper triangles), then u.
template <int NX, int NU, bool FULL>
struct Terms {
  static constexpr int TX = NX * (NX + 1) / 2, TU = NU * (NU + 1) / 2;
  static constexpr int FX = 0, FU = FX + NX * NX, CX = FU + NX * NU,
                       CU = CX + NX, CXX = CU + NU, CUU = CXX + TX,
                       CXU = CUU + TU, FXX = CXU + NX * NU,
                       FUU = FXX + (FULL ? NX * TX : 0),
                       FXU = FUU + (FULL ? NX * TU : 0),
                       LOWER = FXU + (FULL ? NX * NX * NU : 0),
                       UPPER = LOWER + NU, LO_HX = UPPER + NU,
                       UP_HX = LO_HX + NU * NX, LO_S = UP_HX + NU * NX,
                       UP_S = LO_S + NU, U = UP_S + NU, NT = U + NU;
};

// Steps per tile: s, halved until kSlots slots fit the budget.
__host__ __device__ constexpr int fit_steps(int s, int bytes_per_step,
                                            int budget = kSlotBudget) {
  return (s == 1 || kSlots * s * bytes_per_step <= budget)
             ? s
             : fit_steps(s / 2, bytes_per_step, budget);
}

template <typename T, int NT>
__host__ __device__ constexpr int tile_steps() {
  return fit_steps(8, kLanes * NT * static_cast<int>(sizeof(T)));
}

// Backward in time (B1, B3): tile j holds t = N-1 - j*S - s for s = 0 ..
// S-1, those >= 0.  Forward (B2): tile j holds k = j*S + s, those < N.
__host__ __device__ constexpr int num_tiles(int N, int S) {
  return (N + S - 1) / S;
}
__host__ __device__ constexpr int tile_t0(int N, int S, int j) {
  return N - 1 - j * S;
}
__host__ __device__ constexpr int tile_k0(int S, int j) { return j * S; }
__host__ __device__ constexpr int tile_len(int N, int S, int j) {
  return N - j * S < S ? N - j * S : S;
}

// The consumer's share of one tile: lane b (slot column g) runs the steps
// t = t0, t0-1, ... of the tile that exist, reading each step's terms from
// the slot, and writes live * l and live * L.  The loads and the FULL_DDP
// contraction Vx . f** (summed over i = 0 .. NX-1 in index order) are
// backpass_lane's with the bundle replaced by the slot.
template <typename T, int NX, int NU, int REG, bool FULL, int S>
__host__ __device__ __forceinline__ void consume_tile(
    const T* slot, int t0, int g, int b, int B, T lam, Carry<T, NX>& c,
    T* l_out, T* L_out) {
  using K = Terms<NX, NU, FULL>;
  constexpr int TX = K::TX, TU = K::TU;
#pragma unroll 1
  for (int s = 0; s < S && t0 - s >= 0; ++s) {
    const int t = t0 - s;
    const T* q = slot + s * kLanes + g;
    auto ld = [&](int term) -> T { return q[term * S * kLanes]; };
    StepTerms<T, NX, NU> d;
    T u[NU];
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      d.cx[a] = ld(K::CX + a);
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        d.fx[a][e] = ld(K::FX + a * NX + e);
        d.cxx[a][e] = ld(K::CXX + tri(a, e, NX));
      }
#pragma unroll
      for (int e = 0; e < NU; ++e) {
        d.fu[a][e] = ld(K::FU + a * NU + e);
        d.cxu[a][e] = ld(K::CXU + a * NU + e);
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      d.cu[a] = ld(K::CU + a);
#pragma unroll
      for (int e = 0; e < NU; ++e) d.cuu[a][e] = ld(K::CUU + tri(a, e, NU));
      d.lower[a] = ld(K::LOWER + a);
      d.upper[a] = ld(K::UPPER + a);
      d.lo_s[a] = ld(K::LO_S + a);
      d.up_s[a] = ld(K::UP_S + a);
      u[a] = ld(K::U + a);
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        d.lo_hx[a][e] = ld(K::LO_HX + a * NX + e);
        d.up_hx[a][e] = ld(K::UP_HX + a * NX + e);
      }
    }
    if (FULL) {
#pragma unroll
      for (int a = 0; a < NX; ++a) {
#pragma unroll
        for (int e = 0; e < NU; ++e) {
          T s2 = c.Vx[0] * ld(K::FXU + (0 * NX + a) * NU + e);
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s2 = s2 + c.Vx[i] * ld(K::FXU + (i * NX + a) * NU + e);
          d.vfxu[a][e] = s2;
        }
#pragma unroll
        for (int e = 0; e < NX; ++e) {
          T s2 = c.Vx[0] * ld(K::FXX + 0 * TX + tri(a, e, NX));
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s2 = s2 + c.Vx[i] * ld(K::FXX + i * TX + tri(a, e, NX));
          d.vfxx[a][e] = s2;
        }
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int e = 0; e < NU; ++e) {
          T s2 = c.Vx[0] * ld(K::FUU + 0 * TU + tri(a, e, NU));
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s2 = s2 + c.Vx[i] * ld(K::FUU + i * TU + tri(a, e, NU));
          d.vfuu[a][e] = s2;
        }
      }
    }

    StepOut<T, NX, NU> so;
    riccati_step<T, NX, NU, REG, FULL>(d, u, lam, c.Vx, c.Vxx, so);
    const T live = advance(c, so);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      l_out[(static_cast<size_t>(t) * NU + a) * B + b] = live * so.l[a];
#pragma unroll
      for (int e = 0; e < NX; ++e)
        L_out[(static_cast<size_t>(t) * NU * NX + a * NX + e) * B + b] =
            live * so.L[a][e];
    }
  }
}

// A lane's results once its recursion has reached t = 0.
template <typename T, int NX>
__host__ __device__ __forceinline__ void finish_lane(const Carry<T, NX>& c,
                                                     int N, int B, int b,
                                                     T* dV, T* g_norm,
                                                     bool* failed) {
  dV[b] = c.dv0;
  dV[B + b] = c.dv1;
  g_norm[b] = c.g / static_cast<T>(N - 1);
  failed[b] = c.fail > T(0);
}

#ifdef __CUDACC__
// A ring's named barriers: base+1 .. base+kSlots ("slot r full") and
// base+kSlots+1 .. base+2*kSlots ("slot r empty"); 0 is __syncthreads'.
// B1 and B3 have one ring (base 0); B2 adds a second (kSecondRing).  The
// non-aligned forms, so that a warp whose lanes diverged before may reach
// them.
constexpr int kSecondRing = 2 * kSlots;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(threads)
               : "memory");
}

// One tile of a ring's consumer: wait until tile j's slot is full, consume
// it, hand the slot back unless no later tile will refill it.  threads:
// every thread that takes part in the ring, producers and consumers.
template <class Consume>
__device__ __forceinline__ void ring_consume(int j, int ntiles, int threads,
                                             int base, Consume consume) {
  const int r = j % kSlots;
  bar_sync(base + 1 + r, threads);
  consume(j, r);
  __syncwarp();
  if (j + kSlots < ntiles) bar_arrive(base + 1 + kSlots + r, threads);
}

// One tile of a ring's producer: wait until tile j's slot is free (its
// previous tile consumed), fill it, mark it full.
template <class Fill>
__device__ __forceinline__ void ring_produce(int j, int threads, int base,
                                             Fill fill) {
  const int r = j % kSlots;
  if (j >= kSlots) bar_sync(base + 1 + kSlots + r, threads);
  fill(j, r);
  __threadfence_block();
  bar_arrive(base + 1 + r, threads);
}

// A consumer warp's loop over the tiles of ring `base`.
template <class Consume>
__device__ __forceinline__ void consumer_loop(int ntiles, int threads,
                                              int base, Consume consume) {
  for (int j = 0; j < ntiles; ++j)
    ring_consume(j, ntiles, threads, base, consume);
}

// The producer warps' loop over the tiles of ring `base`.
template <class Fill>
__device__ __forceinline__ void producer_loop(int ntiles, int threads,
                                              int base, Fill fill) {
  for (int j = 0; j < ntiles; ++j) ring_produce(j, threads, base, fill);
}

// B1's and B3's loops: one ring that the whole block (THREADS) takes part
// in.
template <int THREADS, class Consume>
__device__ __forceinline__ void consumer_loop(int ntiles, Consume consume) {
  consumer_loop(ntiles, THREADS, 0, consume);
}
template <int THREADS, class Fill>
__device__ __forceinline__ void producer_loop(int ntiles, Fill fill) {
  producer_loop(ntiles, THREADS, 0, fill);
}

// copy(dst, src, n) of a producer's tile copy (backpass.cuh: bundle_fill,
// rollout.cuh: rollout_fill): one 16-byte cp.async where the source is
// aligned and the chunk whole, else one per value.
struct AsyncCopy {
  template <typename T>
  __device__ __forceinline__ void operator()(T* dst, const T* src,
                                             int n) const {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (n * static_cast<int>(sizeof(T)) == 16 &&
        (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src)
                   : "memory");
    } else {
      for (int e = 0; e < n; ++e)
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                         d + e * static_cast<unsigned>(sizeof(T))),
                     "l"(src + e), "n"(sizeof(T))
                     : "memory");
    }
  }
};

// Every cp.async of this thread has landed.
__device__ __forceinline__ void async_copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#endif

}  // namespace ddp
