// The slice epoch for a likelihood evaluated outside the kernel: one
// micro-step of every chain per launch, the likelihood run in torch between
// two launches.
//
// Replaces, for a likelihood written in torch, the TPU kernel
// polychordlite_tpu/ops/pallas_slice_v4.py::build_epoch_fn_pallas_v4
// (:508), which traces any jnp likelihood into its body (the tile path, or
// the single-point evaluator vmapped inside the kernel,
// polychordlite_tpu/ops/pallas_slice.py:125-160).  A CUDA kernel cannot
// call a torch function, so the state machine of slice_machine.cuh is cut
// at the likelihood call (slice_propose, slice_decide) and each lane's state
// lives in device memory between the launches:
//
//   first launch   set every lane up from its seed (a valid lane in INIT_R
//                  of repeat 0, an invalid one done), then propose;
//   then, per round, torch writes logL = calc(probe) and one launch
//     consumes    applies slice_decide to that logL; an accepted (or
//                 budget-capped) repeat writes t, logL, nlike into its
//                 record, an accepted one moves x to the probe and starts
//                 the next repeat;
//     proposes    draws the next probe's chord position t
//                 (slice_propose) and writes probe = x + t n̂ for every lane,
//                 t = 0 for a lane that is done, and sets `active` when a
//                 lane is left running.
//
// ops/pallas_slice_v4.py captures a fixed number of rounds (the likelihood
// and the launch) in one CUDA graph and replays it until `active` reads 0.
// Every lane is evaluated each round, as the plain engine evaluates every
// lane, so the likelihood sees the same shapes and bits as in
// ops/slice_kernel.py::slice_records_plain and the route is bitwise that
// engine; the probe is two rounded operations in torch's order (x + t * n).
//
// What bounds it: not this kernel but the round.  The kernel moves each
// lane's state, x, its direction and its probe once per micro-step (about
// (3 D + 20) * 4 bytes a lane), a few microseconds at the bench geometry;
// the likelihood's own launches and the replay's host read dominate.  One
// thread per chain with D looped, the state structure-of-arrays with the
// chain axis minor so that loads and stores coalesce (the probe, (B, D)
// row-major for torch, does not); no bound on D, since the state is not in
// registers.
//
// Layouts: x0, x (D, B), n̂ (R, D, B), w (R, B), bound, valid, logL (B,);
// the integer state (S_INTS, B) int32, the float state (F_FLOATS, B),
// steps (B,) int64; the probe (B, D); records t, logL (R, B) float32 and
// nlike (R, B) int32.

#include "slice_machine.cuh"

// rows of the integer and float state
enum { S_PHASE, S_RSTEP, S_LSTEP, S_NSHRINK, S_CNT, S_NEED_R, S_NEED_L, S_IT, S_REP, S_HLANE,
       S_INTS };
enum { F_TL, F_TR, F_T, F_FLOATS };

struct StepArgs {
    const float* x0t;    // (D, B) seeds, read by the first launch
    const float* valid;  // (B,), read by the first launch
    const float* bound;  // (B,)
    const float* nhat;   // (R, D, B)
    const float* w;      // (R, B)
    const float* logL;   // (B,) the likelihood of the last probes
    int* ist;            // (S_INTS, B)
    long long* steps;    // (B,) micro-steps of the chain in the epoch
    float* fst;          // (F_FLOATS, B): tL, tR and the pending probe's t
    float* x;            // (D, B) the chain's position
    float* probe;        // (B, D)
    float* t_out;
    float* logL_out;
    int* nlike_out;
    int* active;         // set to 1 when a lane is left running
    int B, D, R;
    uint32_t k0, k1;
    int max_step, max_shrink;
    long long cap;
    float logzero;
};

__device__ __forceinline__ void write_record(const StepArgs& a, int r, int b, float t, float logL,
                                             int cnt) {
    const size_t o = (size_t)r * a.B + b;
    a.t_out[o] = t;
    a.logL_out[o] = logL;
    a.nlike_out[o] = cnt;
}

// One kernel for both kinds of launch (`first` a run-time flag), so that the
// epoch's first launch, outside the CUDA graph, loads the function the
// graph's launches use.
__global__ void slice_step_kernel(StepArgs a, bool first) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const size_t B = a.B;
    const int D = a.D, R = a.R;
    int* v = a.ist;
    SliceState s;
    int rep;
    long long steps;
    uint32_t h_lane;
    if (first) {
        const bool valid = a.valid[b] > 0.5f;
        s.start();
        if (!valid) s.phase = PH_DONE;
        rep = valid ? 0 : R;
        steps = 0;
        h_lane = mix32(mix32(a.k0, a.k1), (uint32_t)b);
        for (int d = 0; d < D; ++d) a.x[d * B + b] = a.x0t[d * B + b];
        for (int r = 0; r < R; ++r) write_record(a, r, b, 0.0f, a.logzero, 0);
    } else {
        s.phase = v[S_PHASE * B + b];
        s.rstep = v[S_RSTEP * B + b];
        s.lstep = v[S_LSTEP * B + b];
        s.nshrink = v[S_NSHRINK * B + b];
        s.cnt = v[S_CNT * B + b];
        s.need_r = v[S_NEED_R * B + b] != 0;
        s.need_l = v[S_NEED_L * B + b] != 0;
        s.it = (uint32_t)v[S_IT * B + b];
        s.tL = a.fst[F_TL * B + b];
        s.tR = a.fst[F_TR * B + b];
        rep = v[S_REP * B + b];
        h_lane = (uint32_t)v[S_HLANE * B + b];
        steps = a.steps[b];
        if (s.phase != PH_DONE) {  // consume the logL of this lane's probe
            const float t = a.fst[F_T * B + b];
            float stored = a.logzero;
            ++steps;
            const bool acc = slice_decide(s, t, a.logL[b], a.bound[b], a.logzero, a.max_step,
                                          a.max_shrink, stored);
            const bool capped = !acc && steps >= a.cap;
            if (acc || capped) write_record(a, rep, b, acc ? t : 0.0f, acc ? stored : a.logzero,
                                            s.cnt);
            if (acc) {  // x moves to the probe: the same two rounded operations
                const float* n = a.nhat + (size_t)rep * D * B;
                for (int d = 0; d < D; ++d)
                    a.x[d * B + b] = __fadd_rn(a.x[d * B + b], __fmul_rn(t, n[d * B + b]));
                s.start();
                if (++rep >= R) s.phase = PH_DONE;
            }
            if (capped || (acc && steps >= a.cap)) s.phase = PH_DONE;  // the epoch's budget
        }
    }
    float t = 0.0f;
    if (s.phase != PH_DONE) {
        t = slice_propose(s, a.w[(size_t)rep * B + b], mix32(h_lane, (uint32_t)rep));
        *a.active = 1;
    }
    const float* n = a.nhat + (size_t)(rep < R ? rep : R - 1) * D * B;
    float* p = a.probe + (size_t)b * D;
    for (int d = 0; d < D; ++d) p[d] = __fadd_rn(a.x[d * B + b], __fmul_rn(t, n[d * B + b]));
    a.fst[F_T * B + b] = t;
    a.fst[F_TL * B + b] = s.tL;
    a.fst[F_TR * B + b] = s.tR;
    v[S_PHASE * B + b] = s.phase;
    v[S_RSTEP * B + b] = s.rstep;
    v[S_LSTEP * B + b] = s.lstep;
    v[S_NSHRINK * B + b] = s.nshrink;
    v[S_CNT * B + b] = s.cnt;
    v[S_NEED_R * B + b] = s.need_r;
    v[S_NEED_L * B + b] = s.need_l;
    v[S_IT * B + b] = (int)s.it;
    v[S_REP * B + b] = rep;
    v[S_HLANE * B + b] = (int)h_lane;
    a.steps[b] = steps;
}

// One launch on `stream`: the first one of an epoch (`first` != 0: set up
// from x0t and valid, then propose) or a round (consume logL, propose).
// All arrays are device arrays in the layouts above, contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int slice_step_launch(int first, const void* x0t, const void* valid,
                                 const void* bound, const void* nhat, const void* w,
                                 const void* logL, void* ist, void* steps, void* fst, void* x,
                                 void* probe, void* t_out, void* logL_out, void* nlike_out,
                                 void* active, int B, int D, int R, unsigned int k0,
                                 unsigned int k1, int max_step, int max_shrink, long long cap,
                                 float logzero, void* stream) {
    if (B < 1 || D < 1 || R < 1) return (int)cudaErrorInvalidValue;
    const StepArgs a{(const float*)x0t, (const float*)valid, (const float*)bound,
                     (const float*)nhat, (const float*)w, (const float*)logL, (int*)ist,
                     (long long*)steps, (float*)fst, (float*)x, (float*)probe, (float*)t_out,
                     (float*)logL_out, (int*)nlike_out, (int*)active, B, D, R, k0, k1,
                     max_step, max_shrink, cap, logzero};
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    const cudaStream_t st = (cudaStream_t)stream;
    slice_step_kernel<<<blocks, threads, 0, st>>>(a, first != 0);
    return (int)cudaGetLastError();
}
