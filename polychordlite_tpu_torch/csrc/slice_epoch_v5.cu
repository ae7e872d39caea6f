// Speculative slice-sampling epoch: packets of P = 4 probes per macro-step,
// one thread per chain.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_slice_v5.py::
// build_epoch_fn_pallas_v5 (kernel body :117-518).  It keeps v5's packet
// machine and drops its TPU layout (lane-chunk grid, SMEM sliding window,
// 8-slot direction ring by manual DMA), as slice_epoch.cu does for v4.
// Each macro-step of a lane
//   1. plans four probe positions before any likelihood result
//      (pallas_slice_v5.py:240-269): in INIT the packet [tR, tL, +w, -w];
//      in STEP_R / STEP_L the ladder +-w (step + j); in SHRINK the chain of
//      candidates under "all rejected", each contracting the side its sign
//      picks;
//   2. evaluates the four probes with the likelihood functor;
//   3. resolves them in order (:271-402): slots are consumed up to and
//      including the first one that diverts the machine (a stepping-out
//      stop, a shrink accept or forced accept); unconsumed slots count
//      nowhere.  In INIT, slots 0 and 1 are always consumed, slot 2 iff the
//      right end was inside, slot 3 iff the left end was inside and STEP_R
//      stopped at slot 2 or never started.
// The uniform of slot j is u = hash(h_rep, it + j) with `it` the probes the
// repeat has consumed, and the accepted position is the evaluated probe
// itself, so the decisions, t, logL and nlike are bitwise those of the v4
// kernel (slice_epoch.cu) and of the plain engines.  The epoch's budget is
// that of slice_epoch.cu: a lane stops after `cap` consumed probes, which
// may end it inside a packet; v5 itself counts macro-steps instead
// (pallas_slice_v5.py:115).
//
// Layout as slice_epoch.cu: x0 (D, B), nhat (R, D, B), w (R, B), chain axis
// minor; outputs t, logL (R, B) float32 and nlike (R, B) int32.
//
// What bounds it on the card: as for slice_epoch.cu, parallelism and warp
// divergence, not arithmetic or bandwidth.  A packet issues four likelihood
// evaluations and consumes about two, so this one-thread-per-chain design
// does more arithmetic than slice_epoch.cu for fewer, less divergent
// sequential steps (every lane of a warp takes the same four-probe body);
// its state stays in registers (D <= SLICE_MAXD).  Spreading a packet over
// a quad of lanes with __shfl_sync is the next design.

#include "likelihoods.cuh"

#define SLICE_P 4

template <class Like>
__global__ void slice_epoch_v5_kernel(Like like, const float* __restrict__ x0t,
                                      const float* __restrict__ bound,
                                      const float* __restrict__ valid,
                                      const float* __restrict__ nhat,
                                      const float* __restrict__ w,
                                      float* __restrict__ t_out,
                                      float* __restrict__ logL_out,
                                      int* __restrict__ nlike_out, int B, int D,
                                      int R, uint32_t k0, uint32_t k1,
                                      int max_step, int max_shrink, long long cap) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float logzero = like.logzero;
    int r = 0;
    if (valid[b] > 0.5f) {
        float x0[SLICE_MAXD];
        float n[SLICE_MAXD];
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d)
            if (d < D) x0[d] = x0t[(size_t)d * B + b];
        const float bnd = bound[b];
        const uint32_t h_lane = mix32(mix32(k0, k1), (uint32_t)b);
        long long steps = 0;  // probes consumed in this epoch
        for (; r < R; ++r) {
#pragma unroll
            for (int d = 0; d < SLICE_MAXD; ++d)
                if (d < D) n[d] = nhat[((size_t)r * D + d) * B + b];
            const float wr = w[(size_t)r * B + b];
            const uint32_t h_rep = mix32(h_lane, (uint32_t)r);
            int phase = PH_INIT_R, rstep = 1, lstep = 1, nshrink = 0, cnt = 0;
            uint32_t it = 0;  // probes consumed in this repeat
            bool need_l = false, accepted = false;
            float tL = 0.0f, tR = 0.0f, t_acc = 0.0f, logL_acc = logzero;
            while (steps < cap) {
                // ---- plan the packet -------------------------------------
                float t[SLICE_P];
                float l_sp = tL, r_sp = tR;  // the shrink chain's interval
                if (phase == PH_INIT_R) {
                    const float u0 = slice_uniform(h_rep, it);
                    t[0] = __fmul_rn(__fsub_rn(1.0f, u0), wr);  // tR
                    t[1] = __fmul_rn(-u0, wr);                  // tL
                    t[2] = wr;                                  // STEP_R, rstep 1
                    t[3] = -wr;                                 // STEP_L, lstep 1
                } else {
#pragma unroll
                    for (int j = 0; j < SLICE_P; ++j) {
                        if (phase == PH_STEP_R) {
                            t[j] = __fmul_rn(wr, (float)(rstep + j));
                        } else if (phase == PH_STEP_L) {
                            t[j] = __fmul_rn(-wr, (float)(lstep + j));
                        } else {
                            const float u = slice_uniform(h_rep, it + j);
                            t[j] = __fadd_rn(l_sp, __fmul_rn(u, __fsub_rn(r_sp, l_sp)));
                            if (t[j] > 0.0f) r_sp = t[j]; else l_sp = t[j];
                        }
                    }
                }
                // ---- evaluate it -------------------------------------------
                float lj[SLICE_P];
                bool in[SLICE_P];
#pragma unroll
                for (int j = 0; j < SLICE_P; ++j) {
                    lj[j] = like_eval(like, x0, n, t[j], D);
                    in[j] = (lj[j] >= bnd) && (lj[j] > logzero);
                }
                // ---- resolve it in order -----------------------------------
                // pos[j]: the order in which slot j is consumed, -1 if not
                int pos[SLICE_P] = {-1, -1, -1, -1};
                int cons = 0;
                bool acc = false;
                if (phase == PH_INIT_R) {
                    const bool stop2 = max_step <= 1 || !in[2];
                    const bool stop3 = max_step <= 1 || !in[3];
                    const bool s2 = in[0];
                    const bool s3 = in[1] && (!in[0] || stop2);
                    pos[0] = 0;
                    pos[1] = 1;
                    cons = 2;
                    if (s2) pos[2] = cons++;
                    if (s3) pos[3] = cons++;
                    need_l = in[1];
                    tR = t[0];
                    tL = t[1];
                    if (s2 && !stop2) {
                        phase = PH_STEP_R;
                        rstep = 2;
                    } else {
                        if (s2) tR = t[2];
                        if (s3 && !stop3) {
                            phase = PH_STEP_L;
                            lstep = 2;
                        } else {
                            if (s3) tL = t[3];
                            phase = PH_SHRINK;
                        }
                    }
                } else if (phase == PH_STEP_R || phase == PH_STEP_L) {
                    const bool right = phase == PH_STEP_R;
                    const int step = right ? rstep : lstep;
                    bool go = true;
#pragma unroll
                    for (int j = 0; j < SLICE_P; ++j) {
                        if (go) {
                            pos[j] = j;
                            cons = j + 1;
                            if (!in[j] || step + j >= max_step) {
                                go = false;
                                if (right) tR = t[j]; else tL = t[j];
                            }
                        }
                    }
                    if (go) {
                        if (right) rstep += SLICE_P; else lstep += SLICE_P;
                    } else if (right) {
                        phase = need_l ? PH_STEP_L : PH_SHRINK;
                        if (need_l) lstep = 1;
                    } else {
                        phase = PH_SHRINK;
                    }
                } else {  // PH_SHRINK: the first accept or forced accept wins
                    bool go = true;
#pragma unroll
                    for (int j = 0; j < SLICE_P; ++j) {
                        if (go) {
                            pos[j] = j;
                            cons = j + 1;
                            const bool forced = !in[j] && (nshrink + j + 1 >= max_shrink);
                            if (in[j] || forced) {
                                go = false;
                                acc = true;
                                t_acc = t[j];
                                logL_acc = in[j] ? lj[j] : logzero;
                            }
                        }
                    }
                    if (go) {
                        tL = l_sp;
                        tR = r_sp;
                        nshrink += SLICE_P;
                    }
                }
                // ---- count, and stop at the epoch's budget -----------------
                const long long rem = cap - steps;
                int counted = 0, counted_in_budget = 0;
#pragma unroll
                for (int j = 0; j < SLICE_P; ++j) {
                    if (pos[j] >= 0 && lj[j] > logzero) {
                        ++counted;
                        if (pos[j] < rem) ++counted_in_budget;
                    }
                }
                if (cons > rem) {  // the budget ends inside this packet
                    cnt += counted_in_budget;
                    steps = cap;
                    break;
                }
                cnt += counted;
                steps += cons;
                it += cons;
                if (acc) {
                    accepted = true;
                    break;
                }
            }
            const size_t o = (size_t)r * B + b;
            nlike_out[o] = cnt;
            if (!accepted) {  // the budget: leave this repeat unaccepted
                t_out[o] = 0.0f;
                logL_out[o] = logzero;
                ++r;
                break;
            }
            t_out[o] = t_acc;
            logL_out[o] = logL_acc;
#pragma unroll
            for (int d = 0; d < SLICE_MAXD; ++d)
                if (d < D) x0[d] = __fadd_rn(x0[d], __fmul_rn(t_acc, n[d]));
        }
    }
    for (; r < R; ++r) {  // invalid lanes and repeats never reached
        const size_t o = (size_t)r * B + b;
        t_out[o] = 0.0f;
        logL_out[o] = logzero;
        nlike_out[o] = 0;
    }
}

// The same interface as slice_epoch_launch (slice_epoch.cu).  Returns
// cudaGetLastError() after the launch.
extern "C" int slice_epoch_v5_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, int max_step, int max_shrink,
    long long cap, float logzero, void* stream) {
    if (D < 1 || D > SLICE_MAXD || R < 1 || B < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 32;
    const int blocks = (B + threads - 1) / threads;
    const int bad = with_likelihood(
        functor, consts, prior_a, prior_s, D, logzero, (cudaStream_t)stream,
        [&](auto like) {
            slice_epoch_v5_kernel<decltype(like)>
                <<<blocks, threads, 0, (cudaStream_t)stream>>>(
                    like, (const float*)x0t, (const float*)bound,
                    (const float*)valid, (const float*)nhat, (const float*)w,
                    (float*)t_out, (float*)logL_out, (int*)nlike_out, B, D, R, k0,
                    k1, max_step, max_shrink, cap);
        });
    if (bad) return bad;
    return (int)cudaGetLastError();
}
