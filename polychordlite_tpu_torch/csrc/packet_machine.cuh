// The speculative-packet machine of v5 (P = 4 probes per macro-step): the
// decisions of B3 (slice_epoch_v5.cu), in one place for its two forms — one
// thread per chain, and a chain on four sub-groups of lanes, one packet
// slot each, where every lane of the chain runs the same machine in step.
// No warp operation lives here: with the intrinsics mapped to plain float
// operations, the header also builds as host C++ (tests/test_torch_v5.py).
//
// A macro-step of a chain (pallas_slice_v5.py:240-402):
//   1. packet_plan places four probes before any likelihood result: in
//      INIT [tR, tL, +w, -w]; in STEP_R / STEP_L the ladder +-w (step + j);
//      in SHRINK the chain of candidates under "all rejected", each
//      contracting the side its sign picks;
//   2. the caller evaluates the four probes;
//   3. packet_resolve consumes them in order: slots up to and including the
//      first one that diverts the machine (a stepping-out stop, a shrink
//      accept or forced accept); unconsumed slots count nowhere.  In INIT,
//      slots 0 and 1 are always consumed, slot 2 iff the right end was
//      inside, slot 3 iff the left end was inside and STEP_R stopped at slot
//      2 or never started.  Then it counts the consumed slots with logL >
//      logzero, and stops at the epoch's budget, which may end the chain
//      inside the packet.
// The uniform of slot j is u = hash(h_rep, it + j) with `it` the probes the
// repeat has consumed, and the accepted position is the evaluated probe
// itself, so the decisions, t, logL and nlike are bitwise those of B1
// (slice_epoch.cu) and of the plain engines.  The budget is B1's, in
// consumed probes; v5 itself counts macro-steps (pallas_slice_v5.py:115).
#pragma once

#include "slice_machine.cuh"

#define SLICE_P 4

// The state of one chain inside one repeat, between macro-steps.
struct PacketState {
    int phase, rstep, lstep, nshrink, cnt;
    bool need_l;
    float tL, tR;
    uint32_t it;  // probes the repeat has consumed: the uniforms' counter

    __device__ __forceinline__ void start() {
        phase = PH_INIT_R;
        rstep = lstep = 1;
        nshrink = cnt = 0;
        need_l = false;
        tL = tR = 0.0f;
        it = 0;
    }
};

// A planned packet: its four chord positions, and the shrink chain's
// interval after them (the interval if every slot is rejected).
struct Packet {
    float t[SLICE_P];
    float l_sp, r_sp;
};

// What a resolved packet did.
struct PacketResult {
    int cons;      // probes consumed
    bool trunc;    // the epoch's budget ended the chain inside the packet
    bool acc;      // the repeat accepted (never with trunc)
    float t, logL; // the accepted position and its logL (logzero if forced)
};

// Plan the packet of state s; u(j) is the uniform of slot j,
// slice_uniform(h_rep, s.it + j), asked for only where a slot draws one.
template <class U>
__device__ __forceinline__ Packet packet_plan(const PacketState& s, float wr, U&& u) {
    Packet p;
    p.l_sp = s.tL;
    p.r_sp = s.tR;
    if (s.phase == PH_INIT_R) {
        const float u0 = u(0);
        p.t[0] = __fmul_rn(__fsub_rn(1.0f, u0), wr);  // tR
        p.t[1] = __fmul_rn(-u0, wr);                  // tL
        p.t[2] = wr;                                  // STEP_R, rstep 1
        p.t[3] = -wr;                                 // STEP_L, lstep 1
    } else {
#pragma unroll
        for (int j = 0; j < SLICE_P; ++j) {
            if (s.phase == PH_STEP_R) {
                p.t[j] = __fmul_rn(wr, (float)(s.rstep + j));
            } else if (s.phase == PH_STEP_L) {
                p.t[j] = __fmul_rn(-wr, (float)(s.lstep + j));
            } else {
                p.t[j] = __fadd_rn(p.l_sp, __fmul_rn(u(j), __fsub_rn(p.r_sp, p.l_sp)));
                if (p.t[j] > 0.0f) p.r_sp = p.t[j]; else p.l_sp = p.t[j];
            }
        }
    }
    return p;
}

// Resolve packet p, whose slots scored lj, in order; count it against `rem`,
// the probes left in the epoch's budget (rem > 0).  Updates s; the caller
// records an accept and moves x0 to the accepted probe.
__device__ __forceinline__ PacketResult packet_resolve(PacketState& s, const Packet& p,
                                                       const float (&lj)[SLICE_P], float bnd,
                                                       float logzero, int max_step,
                                                       int max_shrink, long long rem) {
    bool in[SLICE_P];
#pragma unroll
    for (int j = 0; j < SLICE_P; ++j) in[j] = (lj[j] >= bnd) && (lj[j] > logzero);
    // pos[j]: the order in which slot j is consumed, -1 if not
    int pos[SLICE_P] = {-1, -1, -1, -1};
    int cons = 0;
    bool acc = false;
    float t_acc = 0.0f, logL_acc = logzero;
    if (s.phase == PH_INIT_R) {
        const bool stop2 = max_step <= 1 || !in[2];
        const bool stop3 = max_step <= 1 || !in[3];
        const bool s2 = in[0];
        const bool s3 = in[1] && (!in[0] || stop2);
        pos[0] = 0;
        pos[1] = 1;
        cons = 2;
        if (s2) pos[2] = cons++;
        if (s3) pos[3] = cons++;
        s.need_l = in[1];
        s.tR = p.t[0];
        s.tL = p.t[1];
        if (s2 && !stop2) {
            s.phase = PH_STEP_R;
            s.rstep = 2;
        } else {
            if (s2) s.tR = p.t[2];
            if (s3 && !stop3) {
                s.phase = PH_STEP_L;
                s.lstep = 2;
            } else {
                if (s3) s.tL = p.t[3];
                s.phase = PH_SHRINK;
            }
        }
    } else if (s.phase == PH_STEP_R || s.phase == PH_STEP_L) {
        const bool right = s.phase == PH_STEP_R;
        const int step = right ? s.rstep : s.lstep;
        bool go = true;
#pragma unroll
        for (int j = 0; j < SLICE_P; ++j) {
            if (go) {
                pos[j] = j;
                cons = j + 1;
                if (!in[j] || step + j >= max_step) {
                    go = false;
                    if (right) s.tR = p.t[j]; else s.tL = p.t[j];
                }
            }
        }
        if (go) {
            if (right) s.rstep += SLICE_P; else s.lstep += SLICE_P;
        } else if (right) {
            s.phase = s.need_l ? PH_STEP_L : PH_SHRINK;
            if (s.need_l) s.lstep = 1;
        } else {
            s.phase = PH_SHRINK;
        }
    } else {  // PH_SHRINK: the first accept or forced accept wins
        bool go = true;
#pragma unroll
        for (int j = 0; j < SLICE_P; ++j) {
            if (go) {
                pos[j] = j;
                cons = j + 1;
                const bool forced = !in[j] && (s.nshrink + j + 1 >= max_shrink);
                if (in[j] || forced) {
                    go = false;
                    acc = true;
                    t_acc = p.t[j];
                    logL_acc = in[j] ? lj[j] : logzero;
                }
            }
        }
        if (go) {
            s.tL = p.l_sp;
            s.tR = p.r_sp;
            s.nshrink += SLICE_P;
        }
    }
    // count, and stop at the epoch's budget
    int counted = 0, counted_in_budget = 0;
#pragma unroll
    for (int j = 0; j < SLICE_P; ++j) {
        if (pos[j] >= 0 && lj[j] > logzero) {
            ++counted;
            if (pos[j] < rem) ++counted_in_budget;
        }
    }
    if (cons > rem) {  // the budget ends inside this packet
        s.cnt += counted_in_budget;
        return PacketResult{cons, true, false, 0.0f, logzero};
    }
    s.cnt += counted;
    s.it += cons;
    return PacketResult{cons, false, acc, t_acc, logL_acc};
}

// One thread per chain (B3 at G = 1): the R repeats of chain b in
// macro-steps, its four probes evaluated one after the other.
template <class Like>
__device__ __forceinline__ void packet_chain_epoch(const Like& like, const EpochArgs& a,
                                                        int b) {
    const int B = a.B, D = a.D, R = a.R;
    const float logzero = like.logzero;
    long long steps = 0;  // probes consumed in this epoch
    int r = 0;
    if (a.valid[b] > 0.5f) {
        float x0[SLICE_MAXD], n[SLICE_MAXD];
        slice_load(x0, a.x0t, 0, D, B, b);
        const float bnd = a.bound[b];
        const uint32_t h_lane = mix32(mix32(a.k0, a.k1), (uint32_t)b);
        for (; r < R; ++r) {
            slice_load(n, a.nhat, (size_t)r * D * B, D, B, b);
            const float wr = a.w[(size_t)r * B + b];
            const uint32_t h_rep = mix32(h_lane, (uint32_t)r);
            PacketState s;
            s.start();
            PacketResult res{0, false, false, 0.0f, logzero};
            while (steps < a.cap) {
                const Packet p = packet_plan(
                    s, wr, [&](int j) { return slice_uniform(h_rep, s.it + (uint32_t)j); });
                float lj[SLICE_P];
#pragma unroll
                for (int j = 0; j < SLICE_P; ++j) lj[j] = like_eval(like, x0, n, p.t[j], D);
                res = packet_resolve(s, p, lj, bnd, logzero, a.max_step, a.max_shrink,
                                     a.cap - steps);
                if (res.trunc) {
                    steps = a.cap;
                    break;
                }
                steps += res.cons;
                if (res.acc) break;
            }
            if (!res.acc) {  // the budget: leave this repeat unaccepted, stop
                write_repeat(a, r, b, 0.0f, logzero, s.cnt);
                ++r;
                break;
            }
            write_repeat(a, r, b, res.t, res.logL, s.cnt);
            slice_advance(x0, n, res.t, D);
        }
    }
    for (; r < R; ++r) write_repeat(a, r, b, 0.0f, logzero, 0);  // invalid, never reached
}
