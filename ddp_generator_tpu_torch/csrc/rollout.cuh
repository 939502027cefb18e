// Kernel B2's operands, its one-thread reference and the parts of its
// staged schedule.  __host__ __device__, so tests/test_torch_rollout_host.py
// runs them on the CPU: rollout_lane is the one-thread-per-trajectory
// rollout B2 ran before it was staged (kept as the reference the staged
// kernel must equal bit for bit); rollout_fill is the copy the producer
// warp makes (the copy itself passed in: cp.async on the card, a plain
// loop on the host), chain_tile the chain thread's share of a time tile,
// cost_items, cost_sum and store_tile the cost warps' share, and
// rollout_finish the final cost; rollout_skipped is the entry test of the
// staged line search's stage flag.
//
// A step of a rollout has one true recurrence, x -> dx -> u -> clamp ->
// f -> x, and three things that are not on it: the step's operands (the
// nominal point and the gains, known before the kernel starts), its
// running cost, and the stores of x and u.  The staged kernel gives each
// to other warps (rollout.cu); every floating-point expression is
// rollout_lane's, in its order.
#pragma once

#include "common.cuh"
#include "staged.cuh"

namespace ddp {

// Tile constants, fixed in the source (timed on an H100 by
// scripts/tile_sweep.py; PERF.md).
constexpr int kRolloutLanes = 8;    // lanes a block owns (G)
constexpr int kRolloutSteps = 16;   // steps per tile (S) before fitting
constexpr int kAlphaChunk = 8;      // alphas of a lane one block rolls
constexpr int kRolloutBudget = 96 * 1024;  // bytes the two rings may take

template <typename T>
struct RolloutArgs {
  const T* xnom;   // (N, NX, B)
  const T* unom;   // (N, NU, B)
  const T* l;      // (N, NU, B)
  const T* L;      // (N, NU*NX, B)
  const T* mu_le;  // (N, NHLE, B)
  const T* mu_li;  // (N, NHLI, B)
  const T* x0;     // (NX, B)
  const T* wpl;    // (1, B)
  const T* wpf;    // (1, B)
  const T* mu_fe;  // (NHFE, B)
  const T* mu_fi;  // (NHFI, B)
  const T* alpha;  // MULTI: the (A,) schedule; selected: (1, B) per lane
  const T* params; // flat, model order (models/*.cuh)
  T* cost;         // MULTI: (A, B); selected + WANT_COST: (1, B)
  bool* ok;        // same shape as cost
  T* xs;           // (N, NX, B)   selected only
  T* xf;           // (NX, B)      selected only
  T* us;           // (N, NU, B)   selected only
  // The staged line search's stage flag (ops/cuda_rollout.py): NULL, or a
  // device int that is 0 when no live lane needs this rollout.
  const int* run;
  int N, B, A;
};

// A rollout whose stage flag is 0 reads and writes nothing: every block
// returns at entry, so a stage the line search does not need costs one
// launch and no work, and the flag is decided on the device (the body call
// holds no host read and can be captured in a CUDA graph).
template <typename T>
__host__ __device__ __forceinline__ bool rollout_skipped(
    const RolloutArgs<T>& A) {
  return A.run != nullptr && *A.run == 0;
}

// The operands of one step that do not depend on the state.
template <class M, typename T>
struct StepOperands {
  T xnom[M::NX], unom[M::NU], l[M::NU], L[M::NU * M::NX];
};

// Their order in an input slot, [term][step][lane].
template <class M>
struct RolloutTerms {
  static constexpr int XNOM = 0, UNOM = XNOM + M::NX, LFF = UNOM + M::NU,
                       LFB = LFF + M::NU, NT = LFB + M::NU * M::NX;
};

// Chains (trajectories) a block rolls: its lanes, times its alphas in the
// sweep.  Also the chain stride of an output slot.
template <bool MULTI>
__host__ __device__ constexpr int block_chains() {
  return kRolloutLanes * (MULTI ? kAlphaChunk : 1);
}

// An output slot: x_k for s = 0 .. S (row S, or row n of a short tile,
// holds the state after the tile's last step), then u_k for s = 0 .. S-1;
// [component][step][chain], chains fastest.
template <class M, int S, int NCH>
struct OutSlot {
  static constexpr int U0 = M::NX * (S + 1), SIZE = (U0 + M::NU * S) * NCH;
  __host__ __device__ static constexpr int x(int a, int s, int c) {
    return (a * (S + 1) + s) * NCH + c;
  }
  __host__ __device__ static constexpr int u(int j, int s, int c) {
    return (U0 + j * S + s) * NCH + c;
  }
};

// Steps per tile: kRolloutSteps, halved until both rings fit the budget.
template <class M, typename T, bool MULTI>
__host__ __device__ constexpr int rollout_steps() {
  return fit_steps(kRolloutSteps,
                   (RolloutTerms<M>::NT * kRolloutLanes +
                    (M::NX + M::NU) * block_chains<MULTI>()) *
                       static_cast<int>(sizeof(T)),
                   kRolloutBudget);
}

// u of one step: u0 = u_nom + alpha*l + L*dx, exactly u_nom when alpha is
// 0 (iLQG_func.tem:155-158), then clampU (iLQG_func.tem:68-73):
// sequential, every limit from the unclamped u0.
template <class M, typename T>
__host__ __device__ __forceinline__ void control_step(
    const T* x, const StepOperands<M, T>& o, T alpha, const T* p, int k,
    T* u) {
  constexpr int NX = M::NX, NU = M::NU;
  T dx[NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) dx[a] = x[a] - o.xnom[a];
  T u0[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    T du = alpha * o.l[j];
#pragma unroll
    for (int a = 0; a < NX; ++a) du = du + o.L[j * NX + a] * dx[a];
    const T un = o.unom[j];
    u0[j] = alpha == T(0) ? un : un + du;
    u[j] = u0[j];
  }
#pragma unroll
  for (int i = 0; i < M::NH; ++i) {
    const int j = M::box_index(i);
    const T s = static_cast<T>(M::box_sign(i));
    const T lim = -s * (M::h(i, x, u0, p, k) - s * u0[j]);
    u[j] = M::box_sign(i) > 0 ? nan_min(u[j], lim) : nan_max(u[j], lim);
  }
}

// The running cost of (step k, lane b) at (x, u) with its AL penalties,
// and whether it and the next state xn are finite.
template <class M, typename T>
__host__ __device__ __forceinline__ bool step_cost(const RolloutArgs<T>& A,
                                                   const T* p, int k, int b,
                                                   const T* x, const T* u,
                                                   const T* xn, T* c) {
  const size_t kb = static_cast<size_t>(k);
  T mu_le[arr(M::NHLE)] = {}, mu_li[arr(M::NHLI)] = {};
#pragma unroll
  for (int i = 0; i < M::NHLE; ++i)
    mu_le[i] = A.mu_le[(kb * M::NHLE + i) * A.B + b];
#pragma unroll
  for (int i = 0; i < M::NHLI; ++i)
    mu_li[i] = A.mu_li[(kb * M::NHLI + i) * A.B + b];
  *c = aug_L<M>(x, u, p, k, mu_le, mu_li, A.wpl[b]);
  bool ok = is_finite(*c);
#pragma unroll
  for (int a = 0; a < M::NX; ++a) ok = ok && is_finite(xn[a]);
  return ok;
}

// What a trajectory leaves once it has reached x_N: the total cost
// c_acc + F(x_N) with the hfe/hfi penalties and its ok flag, and in the
// selected mode x_N.
template <class M, typename T, bool MULTI, bool WANT_COST>
__host__ __device__ __forceinline__ void rollout_finish(
    const RolloutArgs<T>& A, const T* p, const T* x, int b, int ai, T c_acc,
    bool ok) {
  const int B = A.B;
  if (MULTI || WANT_COST) {
    T mu_fe[arr(M::NHFE)] = {}, mu_fi[arr(M::NHFI)] = {};
#pragma unroll
    for (int i = 0; i < M::NHFE; ++i) mu_fe[i] = A.mu_fe[i * B + b];
#pragma unroll
    for (int i = 0; i < M::NHFI; ++i) mu_fi[i] = A.mu_fi[i * B + b];
    const T cf = aug_F<M>(x, p, A.N, mu_fe, mu_fi, A.wpf[b]);
    A.cost[ai * B + b] = c_acc + cf;
    A.ok[ai * B + b] = ok && is_finite(cf);
  }
  if (!MULTI) {
#pragma unroll
    for (int a = 0; a < M::NX; ++a) A.xf[a * B + b] = x[a];
  }
}

// Trajectory idx on one thread, reading the operands where they lie:
// idx = ai * B + b in the sweep, b in the selected mode.  Parameters at p
// (a register copy, or A.params for a model whose [k]-indexed tail stays
// in device memory).
template <typename M, typename T, bool MULTI, bool WANT_COST>
__host__ __device__ void rollout_lane(const RolloutArgs<T>& A, const T* p,
                                      int idx) {
  constexpr int NX = M::NX, NU = M::NU;
  const int N = A.N, B = A.B;
  const int ai = MULTI ? idx / B : 0;
  const int b = idx - ai * B;
  const T alpha = MULTI ? A.alpha[ai] : A.alpha[b];
  T x[NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) x[a] = A.x0[a * B + b];
  T c_acc = T(0);
  bool ok = true;

  for (int k = 0; k < N; ++k) {
    const size_t kb = static_cast<size_t>(k);
    StepOperands<M, T> o;
#pragma unroll
    for (int a = 0; a < NX; ++a) o.xnom[a] = A.xnom[(kb * NX + a) * B + b];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      o.unom[j] = A.unom[(kb * NU + j) * B + b];
      o.l[j] = A.l[(kb * NU + j) * B + b];
#pragma unroll
      for (int a = 0; a < NX; ++a)
        o.L[j * NX + a] = A.L[(kb * NU * NX + j * NX + a) * B + b];
    }
    T u[NU], xn[NX], c;
    control_step<M>(x, o, alpha, p, k, u);
    M::f(x, u, p, k, xn);
    const bool ok_k = step_cost<M>(A, p, k, b, x, u, xn, &c);
    if (!MULTI) {
#pragma unroll
      for (int a = 0; a < NX; ++a) A.xs[(kb * NX + a) * B + b] = x[a];
#pragma unroll
      for (int j = 0; j < NU; ++j) A.us[(kb * NU + j) * B + b] = u[j];
    }
    c_acc = c_acc + c;
    ok = ok && ok_k;
#pragma unroll
    for (int a = 0; a < NX; ++a) x[a] = xn[a];
  }
  rollout_finish<M, T, MULTI, WANT_COST>(A, p, x, b, ai, c_acc, ok);
}

// ---- the staged schedule ----

// Steps k0 .. k0+S-1 (those < N) of lanes b0 .. b0+G-1 (those < B) of
// xnom, unom, l and L into an input slot (RolloutTerms order).  The work
// is cut into chunks of 16 bytes of consecutive lanes of one (term, step);
// this caller takes chunks first, first + stride, ...  copy(dst, src, n)
// moves n <= 16/sizeof(T) values (fewer at the ragged lane edge).  What
// lies past N or B is left unwritten: the chain reads none of it.
template <class M, typename T, int S, class Copy>
__host__ __device__ __forceinline__ void rollout_fill(
    const RolloutArgs<T>& A, int k0, int b0, T* slot, int first, int stride,
    Copy copy) {
  constexpr int G = kRolloutLanes;
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // values per chunk
  constexpr int CH = G / E;                            // chunks per row
  static_assert(G % E == 0, "a slot row is whole 16-byte chunks");
  const T* const field[4] = {A.xnom, A.unom, A.l, A.L};
  constexpr int ncomp[4] = {M::NX, M::NU, M::NU, M::NU * M::NX};
  int term = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    for (int i = first; i < ncomp[f] * S * CH; i += stride) {
      const int comp = i / (S * CH), s = (i / CH) % S, ch = i % CH;
      const int k = k0 + s, b = b0 + ch * E;
      if (k >= A.N || b >= A.B) continue;
      const int n = A.B - b < E ? A.B - b : E;
      copy(slot + ((term + comp) * S + s) * G + ch * E,
           field[f] + (static_cast<size_t>(k) * ncomp[f] + comp) * A.B + b,
           n);
    }
    term += ncomp[f];
  }
}

// The chain thread's share of one tile: chain c (lane column g) runs the
// tile's n steps from k0 with its state x, reading each step's operands
// from the input slot one step ahead of their use, and leaves x_k and u_k
// in the output slot; nothing else of a step is on this thread.
template <class M, typename T, int S, int NCH>
__host__ __device__ __forceinline__ void chain_tile(const T* in, T* out,
                                                    int n, int k0, int g,
                                                    int c, T alpha,
                                                    const T* p,
                                                    T (&x)[M::NX]) {
  constexpr int NX = M::NX, NU = M::NU, G = kRolloutLanes;
  using K = RolloutTerms<M>;
  using O = OutSlot<M, S, NCH>;
  auto load = [&](int s, StepOperands<M, T>& o) {
    const T* q = in + s * G + g;
#pragma unroll
    for (int a = 0; a < NX; ++a) o.xnom[a] = q[(K::XNOM + a) * S * G];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      o.unom[j] = q[(K::UNOM + j) * S * G];
      o.l[j] = q[(K::LFF + j) * S * G];
#pragma unroll
      for (int a = 0; a < NX; ++a)
        o.L[j * NX + a] = q[(K::LFB + j * NX + a) * S * G];
    }
  };
  StepOperands<M, T> cur, nxt;
  load(0, cur);
  nxt = cur;
#pragma unroll 2
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) load(s + 1, nxt);
    T u[NU], xn[NX];
    control_step<M>(x, cur, alpha, p, k0 + s, u);
#pragma unroll
    for (int a = 0; a < NX; ++a) out[O::x(a, s, c)] = x[a];
#pragma unroll
    for (int j = 0; j < NU; ++j) out[O::u(j, s, c)] = u[j];
    M::f(x, u, p, k0 + s, xn);
#pragma unroll
    for (int a = 0; a < NX; ++a) x[a] = xn[a];
    cur = nxt;
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) out[O::x(a, n, c)] = x[a];
}

// Chain c of a block: lane column g = c % G, alpha row c / G.
struct Chain {
  int g, b, ai;
  bool live;
};
__host__ __device__ __forceinline__ Chain chain_of(int c, int b0, int a0,
                                                   int na, int B) {
  Chain ch;
  ch.g = c % kRolloutLanes;
  ch.b = b0 + ch.g;
  ch.ai = a0 + c / kRolloutLanes;
  ch.live = c / kRolloutLanes < na && ch.b < B;
  return ch;
}

// The cost warps' work items of one finished tile: one per (step, chain),
// this caller taking items first, first + stride, ...: the running cost
// c_k and its finiteness with x_{k+1}'s, into cbuf/okbuf [step][chain].
template <class M, typename T, int S, int NCH>
__host__ __device__ __forceinline__ void cost_items(
    const RolloutArgs<T>& A, const T* p, const T* out, int n, int k0, int b0,
    int a0, int na, T* cbuf, bool* okbuf, int first, int stride) {
  using O = OutSlot<M, S, NCH>;
  const int nch = kRolloutLanes * na;
  // item i = s * nch + c for i = first, first + stride, ..., walked
  // without a division per item
  const int ds = stride / nch, dc = stride - ds * nch;
  int s = first / nch, c = first - s * nch;
  while (s < n) {
    const Chain ch = chain_of(c, b0, a0, na, A.B);
    if (ch.live) {
      T x[M::NX], xn[M::NX], u[M::NU], ck;
#pragma unroll
      for (int a = 0; a < M::NX; ++a) {
        x[a] = out[O::x(a, s, c)];
        xn[a] = out[O::x(a, s + 1, c)];
      }
#pragma unroll
      for (int j = 0; j < M::NU; ++j) u[j] = out[O::u(j, s, c)];
      okbuf[s * NCH + c] = step_cost<M>(A, p, k0 + s, ch.b, x, u, xn, &ck);
      cbuf[s * NCH + c] = ck;
    }
    s += ds;
    c += dc;
    if (c >= nch) {
      c -= nch;
      ++s;
    }
  }
}

// Then one thread per chain adds the tile's c_k to the chain's sum in k
// order (rollout_lane's association) and ANDs its ok flags.
template <typename T, int NCH>
__host__ __device__ __forceinline__ void cost_sum(const T* cbuf,
                                                  const bool* okbuf, int n,
                                                  int nch, T* c_acc,
                                                  bool* ok_acc, int first,
                                                  int stride) {
  for (int c = first; c < nch; c += stride) {
    T acc = c_acc[c];
    bool ok = ok_acc[c];
    for (int s = 0; s < n; ++s) {
      acc = acc + cbuf[s * NCH + c];
      ok = ok && okbuf[s * NCH + c];
    }
    c_acc[c] = acc;
    ok_acc[c] = ok;
  }
}

// The selected mode's trajectories of one finished tile to device memory,
// one item per (component, step, lane), lanes fastest.
template <class M, typename T, int S, int NCH>
__host__ __device__ __forceinline__ void store_tile(const RolloutArgs<T>& A,
                                                    const T* out, int n,
                                                    int k0, int b0,
                                                    int first, int stride) {
  constexpr int NX = M::NX, NU = M::NU, G = kRolloutLanes;
  using O = OutSlot<M, S, NCH>;
  for (int i = first; i < (NX + NU) * n * G; i += stride) {
    const int g = i % G, s = (i / G) % n, comp = i / (G * n);
    const int b = b0 + g;
    if (b >= A.B) continue;
    const size_t k = static_cast<size_t>(k0 + s);
    if (comp < NX)
      A.xs[(k * NX + comp) * A.B + b] = out[O::x(comp, s, g)];
    else
      A.us[(k * NU + comp - NX) * A.B + b] = out[O::u(comp - NX, s, g)];
  }
}

}  // namespace ddp
