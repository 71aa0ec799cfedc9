/* Lock-free double-buffered trajectory store for controller-rate plan
 * queries — the native runtime piece of the L5 planning/control seam
 * (SURVEY.md section 3.3: get_state/get_effort "called at controller rate
 * (10-50 Hz) from a different thread than update_plan").
 *
 * The reference relies on GIL-atomic attribute assignment for this; here the
 * committed plan lives in a C seqlock so a controller thread (Python via
 * ctypes, or a C/C++ control stack linking this .so directly) reads
 * consistent (x_seq, u_seq, T) snapshots with zero locks, zero allocation,
 * and no GIL dependence, while the planner republishes at replan rate.
 *
 * Concurrency model: single publisher, any number of readers.
 *  - publish: seq++ (odd = write in progress), memcpy into the inactive
 *    buffer, flip active index, seq++ (even = consistent).
 *  - read: load seq (spin while odd), read, re-check seq unchanged.
 * Memory ordering via GCC atomic builtins (acquire/release).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    float  *x;        /* (P, n) row-major plan states   */
    float  *u;        /* (P-1, m) row-major plan efforts */
    int32_t P;        /* state samples                   */
    int32_t n;        /* state dim                       */
    int32_t m;        /* control dim                     */
    double  dt;       /* sample period                   */
} plan_buf_t;

typedef struct {
    plan_buf_t     buf[2];
    int32_t        cap_P, n, m;   /* allocation geometry (fixed at ts_new) */
    volatile int   active;        /* index of the readable buffer          */
    volatile unsigned long seq;   /* seqlock counter (odd = writing)       */
} trajserver_t;

trajserver_t *ts_new(int32_t cap_P, int32_t n, int32_t m)
{
    trajserver_t *ts = (trajserver_t *)calloc(1, sizeof(trajserver_t));
    if (!ts) return NULL;
    for (int i = 0; i < 2; i++) {
        ts->buf[i].x = (float *)calloc((size_t)cap_P * n, sizeof(float));
        ts->buf[i].u = (float *)calloc((size_t)cap_P * m, sizeof(float));
        if (!ts->buf[i].x || !ts->buf[i].u) return NULL;
        ts->buf[i].P = 0;
        ts->buf[i].n = n;
        ts->buf[i].m = m;
        ts->buf[i].dt = 0.0;
    }
    ts->cap_P = cap_P;
    ts->n = n;
    ts->m = m;
    ts->active = 0;
    ts->seq = 0;
    return ts;
}

void ts_free(trajserver_t *ts)
{
    if (!ts) return;
    for (int i = 0; i < 2; i++) {
        free(ts->buf[i].x);
        free(ts->buf[i].u);
    }
    free(ts);
}

/* Publish a new plan (planner thread).  Returns 0 on success, -1 if the
 * plan exceeds the preallocated capacity. */
int ts_publish(trajserver_t *ts, const float *x_seq, const float *u_seq,
               int32_t P, double dt)
{
    if (P > ts->cap_P || P < 1) return -1;
    int inactive = 1 - ts->active;
    plan_buf_t *b = &ts->buf[inactive];
    memcpy(b->x, x_seq, (size_t)P * ts->n * sizeof(float));
    if (P > 1)
        memcpy(b->u, u_seq, (size_t)(P - 1) * ts->m * sizeof(float));
    b->P = P;
    b->dt = dt;
    __atomic_add_fetch(&ts->seq, 1, __ATOMIC_RELEASE);   /* odd: writing */
    ts->active = inactive;
    __atomic_add_fetch(&ts->seq, 1, __ATOMIC_RELEASE);   /* even: stable */
    return 0;
}

/* Interpolated state at time t (controller thread).  Linear interpolation
 * between dt samples, endpoint hold outside [0, T] — the reference C11
 * semantics.  Returns plan version (>=2) or 0 if no plan published yet. */
unsigned long ts_state(trajserver_t *ts, double t, float *out)
{
    for (;;) {
        unsigned long s0 = __atomic_load_n(&ts->seq, __ATOMIC_ACQUIRE);
        if (s0 == 0) return 0;
        if (s0 & 1UL) continue;                          /* write in flight */
        const plan_buf_t *b = &ts->buf[ts->active];
        int32_t P = b->P, n = b->n;
        double tau = t / b->dt;
        if (tau < 0.0) tau = 0.0;
        if (tau > (double)(P - 1)) tau = (double)(P - 1);
        int32_t i = (int32_t)tau;
        int32_t j = i + 1 < P ? i + 1 : P - 1;
        float a = (float)(tau - (double)i);
        const float *xi = b->x + (size_t)i * n;
        const float *xj = b->x + (size_t)j * n;
        for (int32_t k = 0; k < n; k++)
            out[k] = (1.0f - a) * xi[k] + a * xj[k];
        unsigned long s1 = __atomic_load_n(&ts->seq, __ATOMIC_ACQUIRE);
        if (s0 == s1) return s0;                         /* consistent read */
    }
}

/* Interpolated effort at time t; linear between effort samples, endpoint
 * hold — matching Planner.get_effort (reference C11).  Returns version or
 * 0. */
unsigned long ts_effort(trajserver_t *ts, double t, float *out)
{
    for (;;) {
        unsigned long s0 = __atomic_load_n(&ts->seq, __ATOMIC_ACQUIRE);
        if (s0 == 0) return 0;
        if (s0 & 1UL) continue;
        const plan_buf_t *b = &ts->buf[ts->active];
        int32_t P = b->P, m = b->m;
        int32_t nu = P - 1;
        if (nu < 1) {
            for (int32_t k = 0; k < m; k++) out[k] = 0.0f;
        } else {
            double tau = t / b->dt;
            if (tau < 0.0) tau = 0.0;
            if (tau > (double)(nu - 1)) tau = (double)(nu - 1);
            int32_t i = (int32_t)tau;
            int32_t j = i + 1 < nu ? i + 1 : nu - 1;
            float a = (float)(tau - (double)i);
            const float *ui = b->u + (size_t)i * m;
            const float *uj = b->u + (size_t)j * m;
            for (int32_t k = 0; k < m; k++)
                out[k] = (1.0f - a) * ui[k] + a * uj[k];
        }
        unsigned long s1 = __atomic_load_n(&ts->seq, __ATOMIC_ACQUIRE);
        if (s0 == s1) return s0;
    }
}

double ts_duration(trajserver_t *ts)
{
    for (;;) {
        unsigned long s0 = __atomic_load_n(&ts->seq, __ATOMIC_ACQUIRE);
        if (s0 == 0) return 0.0;
        if (s0 & 1UL) continue;
        const plan_buf_t *b = &ts->buf[ts->active];
        double T = b->dt * (double)(b->P - 1);
        unsigned long s1 = __atomic_load_n(&ts->seq, __ATOMIC_ACQUIRE);
        if (s0 == s1) return T;
    }
}
