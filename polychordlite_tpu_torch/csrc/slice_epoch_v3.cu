// The v3 slice epoch (B4): one chain on a group of G lanes, under v3's
// per-step budget.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_slice_v3.py::
// build_epoch_fn_pallas_v3 (:72-345; kernel body :93-287).  v3 runs
// grid=(R,) steps over one tile of lanes: step r streams repeat r+3's
// directions into a ring of RC = 4 slots, lanes run through their own
// repeats freely up to three ahead of r (the ones further ahead stall), and
// the step ends when every lane has finished repeat r, or after cap_body
// loops of 4 micro-steps; then slot r is flushed to the outputs.
//
// The ring, the stalls and the flush are not carried over.  They exist
// because the TPU grid runs in order over one tile and per-lane indexing is
// costly there; a lane's uniforms are keyed on its own (repeat, micro-step),
// so a stall never changes what it decides.  Here each chain runs its
// repeats freely on slice_epoch.cuh's template under V3Policy: each repeat
// gets the budget of one v3 grid step, cap_body * 4 micro-steps (passed as
// `cap`), counted afresh every repeat (PER_REPEAT); a repeat that the budget
// ends records t = 0, logL = logzero and its count, and the chain stops
// (STOP); no cube is written (positions are rebuilt outside as seed +
// cumsum(t n̂), ops/pallas_slice_v4.py, as v3 does at pallas_slice_v3.py:
// 395-399).  That budget cannot bind: cap_body * 4 >= 2 + 2 max_step +
// max_shrink + 16, more than a repeat can take, so t, logL and nlike are
// those of slice_epoch.cu bit for bit.  If it did bind, v3 would let the
// lagging lane run on and write its repeat into a ring slot already flushed
// and recycled (pallas_slice_v3.py:278-287, ROADMAP C9); this kernel stops
// the chain instead, as slice_epoch.cu does at its budget.
//
// What bounds it on the card is B1's micro-step (slice_epoch.cuh): one
// chain's dependent chain of hash, state machine and D divisions, with too
// few warps to hide it when one thread holds a chain.  So B4 is B1's design:
// G lanes of a warp per chain, the warp's chains in one loop of
// micro-steps, G picked as for B1 (ops/pallas_slice_v4.py::choose_group: 8
// at the bench's 8,192 20-D chains, 16 at gaussian.ini's 512, 2 for 2-D
// models at 512).  G = 1 is the template's one-thread loop (chain_epoch).
// With a budget that cannot bind, each instantiation is B1's loop plus the
// per-repeat reset of its step count, and takes B1's time: on an H100 80GB
// HBM3 at 700 W (chip_smoke.py; PERF.md, section 6) 0.81 ms at the bench
// at G = 8 (G = 1 1.68 ms, B1 0.80 in the same run), 0.18 ms at
// gaussian.ini's shape at G = 16 (B1 0.18); at D = 2 the rule's G = 2
// (0.20 ms) does not beat G = 1 (0.195), as for B1 and B5.
//
// Layout: EpochArgs (slice_machine.cuh): x0 (D, B), nhat (R, D, B), w
// (R, B), chain axis minor; outputs t, logL (R, B) float32, nlike (R, B)
// int32.

#include "slice_epoch.cuh"

// The interface of slice_epoch_launch (slice_epoch.cu), with `cap` the
// micro-steps one repeat may take and `group` G, the lanes per chain (1, 2,
// 4, 8, 16 or 32; 32 for D > 32, the SLICE_MAXD_WIDE bucket).  Returns
// cudaGetLastError() after the launch.
extern "C" int slice_epoch_v3_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, int group) {
    const EpochArgs a = at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out,
                                            nlike_out, B, D, R, k0, k1, max_step, max_shrink,
                                            cap), lane0);
    if (!epoch_args_ok(a, group, SLICE_MAXD_WIDE)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int bad = with_bucket_likelihood(
        functor, consts, prior_a, prior_s, a, logzero, st,
        [&](auto like) { launch_epoch_group<V3Policy>(group, like, a, st); });
    if (bad) return bad;
    return (int)cudaGetLastError();
}
