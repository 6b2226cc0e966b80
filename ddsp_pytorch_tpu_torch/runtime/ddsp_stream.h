/* ddsp_stream — double-buffered block-streaming engine (C API).
 *
 * Role parity: the block-pipelining half of the reference's Pd external
 * (realtime/ddsp_tilde/ddsp_tilde.cpp:67-98): an audio callback delivers
 * small ticks of pitch/loudness control signal and consumes audio; every
 * time a full model block is accumulated, the previous block's render is
 * collected and the next one dispatched to a worker, hiding model latency
 * behind a 2*block_size-sample pipeline delay.
 *
 * Design differences (on purpose):
 *   - a persistent worker thread with condition-variable handoff instead of
 *     spawn/join per block (ddsp_tilde.cpp:87 spawns a std::thread per
 *     block; thread creation on the audio path risks XRuns);
 *   - destroy() joins the worker (the reference never joins its in-flight
 *     thread on free — ddsp_tilde.cpp:48-52, a latent leak/race noted in
 *     SURVEY.md §5);
 *   - the renderer is a callback, so the same engine drives any backend —
 *     the CPython-embedded PyTorch model (ddsp_model.h), a test sine, or
 *     an RPC client.
 *
 * Threading contract: process() is called from exactly one (audio) thread;
 * the render callback runs on the engine's worker thread.
 */

#ifndef DDSP_STREAM_H
#define DDSP_STREAM_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Renders one block: reads n samples of pitch (Hz) and loudness, writes n
 * samples of audio.  Runs on the worker thread. */
typedef void (*ddsp_render_fn)(const float *pitch, const float *loudness,
                               float *out, int n, void *ctx);

/* Renders one block with an input-audio channel (mfcc-autoencoder bundles:
 * DAW-side timbre transfer feeds the signal to re-synthesize).  Runs on the
 * worker thread. */
typedef void (*ddsp_render_audio_fn)(const float *pitch,
                                     const float *loudness,
                                     const float *audio, float *out, int n,
                                     void *ctx);

typedef struct ddsp_stream_engine ddsp_stream_engine;

/* block_size: samples per model block (reference B_SIZE=1024,
 * ddsp_tilde.cpp:7). */
ddsp_stream_engine *ddsp_stream_create(int block_size, ddsp_render_fn render,
                                       void *ctx);

/* Engine variant whose renderer also receives the double-buffered input
 * audio channel.  Exceeds the reference external (pitch/loudness inlets
 * only, ddsp_tilde.cpp:36-46): it carries three input rings instead of
 * two.  Feed it with ddsp_stream_process_audio; plain
 * ddsp_stream_process works too and renders with a silent audio channel. */
ddsp_stream_engine *ddsp_stream_create_audio(int block_size,
                                             ddsp_render_audio_fn render,
                                             void *ctx);

/* Joins the worker and frees the engine. */
void ddsp_stream_destroy(ddsp_stream_engine *engine);

/* Audio-thread tick: push n samples of control input, pop n samples of
 * audio.  n must divide block_size (Pd ticks are 64; block 1024).
 * Returns 0 on success, -1 on bad n. */
int ddsp_stream_process(ddsp_stream_engine *engine, const float *pitch,
                        const float *loudness, float *out, int n);

/* Audio-thread tick with an input-audio channel (engines from
 * ddsp_stream_create_audio; on a plain engine the audio is ignored).
 * Same contract as ddsp_stream_process otherwise. */
int ddsp_stream_process_audio(ddsp_stream_engine *engine, const float *pitch,
                              const float *loudness, const float *audio,
                              float *out, int n);

/* Pipeline latency in samples (2 * block_size). */
int ddsp_stream_latency(const ddsp_stream_engine *engine);

/* The engine's model block size (as passed to create). */
int ddsp_stream_block(const ddsp_stream_engine *engine);

/* Number of blocks rendered by the worker so far. */
int64_t ddsp_stream_blocks_rendered(const ddsp_stream_engine *engine);

/* Number of times the audio thread had to wait on the worker (a non-zero
 * value means the model is slower than realtime for this block size). */
int64_t ddsp_stream_underruns(const ddsp_stream_engine *engine);

#ifdef __cplusplus
}
#endif

#endif /* DDSP_STREAM_H */
