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
//
// The repeat barrier (the graded route of a GradedLikelihood, engine
// "scan"): a lane proposes only while its repeat is below `rep_limit`, an
// int in device memory, so that one captured graph serves every repeat.  A
// lane that has reached it (a repeat accepted, the next one started in
// INIT_R) proposes nothing: its t is 0, its probe is x, it does not set
// `active`, and its "probe pending" row (S_PEND) is cleared, so the next
// launch neither consumes a logL for it nor counts a step.  The host raises
// `rep_limit` by one per repeat and replays the graph of that repeat's grade
// (the full likelihood, or the fast part on the cached slow intermediate)
// until `active` reads 0: every repeat then runs in lockstep across the
// batch, as the JAX package's scan engine runs them
// (polychordlite_tpu/ops/slice_kernel.py::build_epoch_fn_scan, :193), while
// each lane's decisions stay those of the free-running route: its uniforms
// are keyed on (key words, lane, repeat, iteration) and its budget counts
// only the steps it takes.  With rep_limit = R a lane is pending exactly
// when it is not done, and the kernel is the traced route's.
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
// registers.  Under the repeat barrier the round is the same, plus one
// launch per repeat that only proposes; each repeat lasts as long as its
// slowest lane, and the probes of the lanes that wait are evaluated for
// nothing: what the graded route pays for evaluating the slow part of the
// likelihood only in slow-grade repeats.
//
// Layouts: x0, x (D, B), n̂ (R, D, B), w (R, B), bound, valid, logL (B,);
// the integer state (S_INTS, B) int32, the float state (F_FLOATS, B),
// steps (B,) int64; the probe (B, D); records t, logL (R, B) and nlike
// (R, B) int32.
//
// The kernel is a template on the scalar type T of its float arrays and
// state: float (slice_step_launch), or double (slice_step_launch_f64) for a
// run at precision='highest', where torch evaluates the likelihood in
// float64 between the launches.  Double doubles the bytes of x, n̂, the
// probe and the float state a round moves.

#include "slice_machine.cuh"

// rows of the integer and float state
enum { S_PHASE, S_RSTEP, S_LSTEP, S_NSHRINK, S_CNT, S_NEED_R, S_NEED_L, S_IT, S_REP, S_HLANE,
       S_PEND, S_INTS };
enum { F_TL, F_TR, F_T, F_FLOATS };

template <class T>
struct StepArgs {
    const T* x0t;    // (D, B) seeds, read by the first launch
    const T* valid;  // (B,), read by the first launch
    const T* bound;  // (B,)
    const T* nhat;   // (R, D, B)
    const T* w;      // (R, B)
    const T* logL;   // (B,) the likelihood of the last probes
    int* ist;            // (S_INTS, B)
    long long* steps;    // (B,) micro-steps of the chain in the epoch
    T* fst;          // (F_FLOATS, B): tL, tR and the pending probe's t
    T* x;            // (D, B) the chain's position
    T* probe;        // (B, D)
    T* t_out;
    T* logL_out;
    int* nlike_out;
    int* active;         // set to 1 when a lane is left running
    const int* rep_limit;  // (1,): a lane proposes only while rep < *rep_limit
    int B, D, R;
    uint32_t k0, k1;
    uint32_t lane0;  // the launch's first lane in the whole batch (a shard's)
    int max_step, max_shrink;
    long long cap;
    T logzero;
};

template <class T>
__device__ __forceinline__ void write_record(const StepArgs<T>& a, int r, int b, exactly<T> t,
                                             exactly<T> logL, int cnt) {
    const size_t o = (size_t)r * a.B + b;
    a.t_out[o] = t;
    a.logL_out[o] = logL;
    a.nlike_out[o] = cnt;
}

// One kernel for both kinds of launch (`first` a run-time flag), so that the
// epoch's first launch, outside the CUDA graph, loads the function the
// graph's launches use.
template <class T>
__global__ void slice_step_kernel(StepArgs<T> a, bool first) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const size_t B = a.B;
    const int D = a.D, R = a.R;
    int* v = a.ist;
    SliceStateT<T> s;
    int rep;
    long long steps;
    uint32_t h_lane;
    bool pending = false;  // the lane's probe of the last launch awaits its logL
    if (first) {
        const bool valid = a.valid[b] > 0.5f;
        s.start();
        if (!valid) s.phase = PH_DONE;
        rep = valid ? 0 : R;
        steps = 0;
        h_lane = mix32(mix32(a.k0, a.k1), a.lane0 + (uint32_t)b);
        for (int d = 0; d < D; ++d) a.x[d * B + b] = a.x0t[d * B + b];
        for (int r = 0; r < R; ++r) write_record(a, r, b, T(0), a.logzero, 0);
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
        pending = v[S_PEND * B + b] != 0;
        if (s.phase != PH_DONE && pending) {  // consume the logL of this lane's probe
            const T t = a.fst[F_T * B + b];
            T stored = a.logzero;
            ++steps;
            const bool acc = slice_decide(s, t, a.logL[b], a.bound[b], a.logzero, a.max_step,
                                          a.max_shrink, stored);
            const bool capped = !acc && steps >= a.cap;
            if (acc || capped) write_record(a, rep, b, acc ? t : T(0), acc ? stored : a.logzero,
                                            s.cnt);
            if (acc) {  // x moves to the probe: the same two rounded operations
                const T* n = a.nhat + (size_t)rep * D * B;
                for (int d = 0; d < D; ++d)
                    a.x[d * B + b] = rn_add(a.x[d * B + b], rn_mul(t, n[d * B + b]));
                s.start();
                if (++rep >= R) s.phase = PH_DONE;
            }
            if (capped || (acc && steps >= a.cap)) s.phase = PH_DONE;  // the epoch's budget
        }
    }
    T t = T(0);
    pending = s.phase != PH_DONE && rep < *a.rep_limit;
    if (pending) {
        t = slice_propose(s, a.w[(size_t)rep * B + b], mix32(h_lane, (uint32_t)rep));
        *a.active = 1;
    }
    const T* n = a.nhat + (size_t)(rep < R ? rep : R - 1) * D * B;
    T* p = a.probe + (size_t)b * D;
    for (int d = 0; d < D; ++d) p[d] = rn_add(a.x[d * B + b], rn_mul(t, n[d * B + b]));
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
    v[S_PEND * B + b] = pending;
    a.steps[b] = steps;
}

template <class T>
static int launch(int first, const void* x0t, const void* valid, const void* bound,
                  const void* nhat, const void* w, const void* logL, void* ist, void* steps,
                  void* fst, void* x, void* probe, void* t_out, void* logL_out,
                  void* nlike_out, void* active, const void* rep_limit, int B, int D, int R,
                  unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
                  int max_shrink, long long cap, T logzero, void* stream) {
    if (B < 1 || D < 1 || R < 1) return (int)cudaErrorInvalidValue;
    const StepArgs<T> a{(const T*)x0t, (const T*)valid, (const T*)bound, (const T*)nhat,
                        (const T*)w, (const T*)logL, (int*)ist, (long long*)steps, (T*)fst,
                        (T*)x, (T*)probe, (T*)t_out, (T*)logL_out, (int*)nlike_out,
                        (int*)active, (const int*)rep_limit, B, D, R, k0, k1, lane0, max_step,
                        max_shrink, cap, logzero};
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    const cudaStream_t st = (cudaStream_t)stream;
    slice_step_kernel<T><<<blocks, threads, 0, st>>>(a, first != 0);
    return (int)cudaGetLastError();
}

// One launch on `stream`: the first one of an epoch (`first` != 0: set up
// from x0t and valid, then propose) or a round (consume logL, propose).
// All arrays are device arrays in the layouts above, contiguous, float32;
// rep_limit is one device int (R for the traced route); lane0 is the
// launch's first lane in the whole batch (slice_epoch.cu), read by the
// first launch alone.
// Returns cudaGetLastError() after the launch.
extern "C" int slice_step_launch(int first, const void* x0t, const void* valid,
                                 const void* bound, const void* nhat, const void* w,
                                 const void* logL, void* ist, void* steps, void* fst, void* x,
                                 void* probe, void* t_out, void* logL_out, void* nlike_out,
                                 void* active, const void* rep_limit, int B, int D, int R,
                                 unsigned int k0, unsigned int k1, unsigned int lane0,
                                 int max_step, int max_shrink, long long cap, float logzero,
                                 void* stream) {
    return launch<float>(first, x0t, valid, bound, nhat, w, logL, ist, steps, fst, x, probe,
                         t_out, logL_out, nlike_out, active, rep_limit, B, D, R, k0, k1, lane0,
                         max_step, max_shrink, cap, logzero, stream);
}

// The same with the float arrays and logzero in float64.
extern "C" int slice_step_launch_f64(int first, const void* x0t, const void* valid,
                                     const void* bound, const void* nhat, const void* w,
                                     const void* logL, void* ist, void* steps, void* fst,
                                     void* x, void* probe, void* t_out, void* logL_out,
                                     void* nlike_out, void* active, const void* rep_limit,
                                     int B, int D, int R, unsigned int k0, unsigned int k1,
                                     unsigned int lane0, int max_step, int max_shrink,
                                         long long cap,
                                     double logzero, void* stream) {
    return launch<double>(first, x0t, valid, bound, nhat, w, logL, ist, steps, fst, x, probe,
                          t_out, logL_out, nlike_out, active, rep_limit, B, D, R, k0, k1, lane0,
                          max_step, max_shrink, cap, logzero, stream);
}
