/*
 * Native audio runtime for the TPU TTS stack.
 *
 * The reference's native tier is CUDA/C++ (csrc/kernel.cu + torch
 * bindings); on TPU the compute kernels are Pallas/Mosaic, and the native
 * tier lives where native code still earns its keep in a serving stack:
 * the audio byte path. This module provides:
 *
 *   - f32 → PCM16 conversion with clipping (the hot per-chunk transform in
 *     the Pipecat service, reference: pipecat_tts.py:135-139), vectorizable
 *     by the compiler;
 *   - a lock-free single-producer/single-consumer ring buffer for PCM
 *     bytes, so a synthesis thread can feed a transport thread without the
 *     GIL in the way;
 *   - a minimal WAV (RIFF) writer.
 *
 * Built by qwen_tts_tpu/runtime/native.py with cc -O3 -shared; loaded via
 * ctypes. Pure C99, no Python.h dependency.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <stdio.h>

/* ── f32 → s16 with clip ──────────────────────────────────────────────── */

void f32_to_pcm16(const float *in, int16_t *out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        float v = in[i];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        out[i] = (int16_t)(v * 32767.0f);
    }
}

/* ── SPSC ring buffer ─────────────────────────────────────────────────── */

typedef struct {
    uint8_t *buf;
    int64_t capacity;          /* bytes, power of two */
    volatile int64_t head;     /* write index (producer) */
    volatile int64_t tail;     /* read index (consumer)  */
} ring_t;

ring_t *ring_create(int64_t capacity) {
    int64_t cap = 1;
    while (cap < capacity) cap <<= 1;
    ring_t *r = (ring_t *)malloc(sizeof(ring_t));
    if (!r) return NULL;
    r->buf = (uint8_t *)malloc((size_t)cap);
    if (!r->buf) { free(r); return NULL; }
    r->capacity = cap;
    r->head = 0;
    r->tail = 0;
    return r;
}

void ring_destroy(ring_t *r) {
    if (r) { free(r->buf); free(r); }
}

int64_t ring_size(const ring_t *r) { return r->head - r->tail; }
int64_t ring_space(const ring_t *r) { return r->capacity - ring_size(r); }

/* returns bytes written (0 if insufficient space — all-or-nothing) */
int64_t ring_write(ring_t *r, const uint8_t *data, int64_t n) {
    if (n > ring_space(r)) return 0;
    int64_t mask = r->capacity - 1;
    int64_t pos = r->head & mask;
    int64_t first = r->capacity - pos;
    if (first > n) first = n;
    memcpy(r->buf + pos, data, (size_t)first);
    if (n > first) memcpy(r->buf, data + first, (size_t)(n - first));
    __sync_synchronize();
    r->head += n;
    return n;
}

/* returns bytes read (may be < n) */
int64_t ring_read(ring_t *r, uint8_t *out, int64_t n) {
    int64_t avail = ring_size(r);
    if (n > avail) n = avail;
    if (n <= 0) return 0;
    int64_t mask = r->capacity - 1;
    int64_t pos = r->tail & mask;
    int64_t first = r->capacity - pos;
    if (first > n) first = n;
    memcpy(out, r->buf + pos, (size_t)first);
    if (n > first) memcpy(out + first, r->buf, (size_t)(n - first));
    __sync_synchronize();
    r->tail += n;
    return n;
}

/* ── WAV writer ───────────────────────────────────────────────────────── */

static void wr32(uint8_t *p, uint32_t v) {
    p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
    p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}
static void wr16(uint8_t *p, uint16_t v) { p[0] = v & 0xff; p[1] = (v >> 8) & 0xff; }

/* returns 0 on success */
int write_wav(const char *path, const int16_t *pcm, int64_t n_samples,
              int32_t sample_rate, int16_t channels) {
    FILE *f = fopen(path, "wb");
    if (!f) return -1;
    uint32_t data_bytes = (uint32_t)(n_samples * 2);
    uint8_t h[44];
    memcpy(h, "RIFF", 4); wr32(h + 4, 36 + data_bytes);
    memcpy(h + 8, "WAVEfmt ", 8); wr32(h + 16, 16);
    wr16(h + 20, 1);                    /* PCM */
    wr16(h + 22, (uint16_t)channels);
    wr32(h + 24, (uint32_t)sample_rate);
    wr32(h + 28, (uint32_t)(sample_rate * channels * 2));
    wr16(h + 32, (uint16_t)(channels * 2));
    wr16(h + 34, 16);
    memcpy(h + 36, "data", 4); wr32(h + 40, data_bytes);
    int ok = fwrite(h, 1, 44, f) == 44 &&
             fwrite(pcm, 2, (size_t)n_samples, f) == (size_t)n_samples;
    fclose(f);
    return ok ? 0 : -1;
}
