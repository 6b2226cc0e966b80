/* DDSPModel — native model host for exported bundles, on PyTorch.
 *
 * Role parity: realtime/ddsp_tilde/ddsp_model.{h,cpp} of the reference,
 * which wraps a TorchScript module behind load()/perform(), and the JAX
 * package's runtime/ddsp_model.{h,cpp}, which drives the jitted streaming
 * step.  Here the host embeds CPython (raw C API — no pybind11) and drives
 * ddsp_pytorch_tpu_torch.export.make_stream_session: the StreamingSynth
 * (decoder bundles) or AutoencoderStreamSession (mfcc-autoencoder bundles)
 * on the CUDA card, whose oscillator bank is the hand-written forward
 * kernel.  The embedding costs one GIL acquire, the host→device copy of
 * the controls and the device→host copy of the audio per block.
 *
 * Device: DDSP_DEVICE (environment) names the torch device the session is
 * built on; unset, it is "cuda", and a machine without a card fails to
 * load.  DDSP_DEVICE=cpu runs the plain PyTorch path (tests).
 *
 * Thread contract: load() from any thread once; perform() from one thread
 * at a time (the stream engine's worker).  The GIL is acquired per call,
 * and each call runs on the CUDA device and stream the session was built
 * on, whatever thread it comes from.
 */

#ifndef DDSP_MODEL_H
#define DDSP_MODEL_H

#ifdef __cplusplus
extern "C" {
#endif

typedef struct ddsp_model ddsp_model;

/* Initialize the embedded interpreter (idempotent, call once per process).
 * extra_sys_path may be NULL; pass the repo root when the package is not
 * installed. */
int ddsp_runtime_init(const char *extra_sys_path);

/* Load an exported bundle directory (ddsp_<name>_bundle) on DDSP_DEVICE.
 * Returns NULL on failure (the Python error printed to stderr). */
ddsp_model *ddsp_model_load(const char *bundle_dir);

void ddsp_model_free(ddsp_model *model);

/* Render n samples: pitch (Hz) + loudness in, audio out.  n must be a
 * multiple of the model's block_size.  Returns 0 on success.  Fails for
 * mfcc-autoencoder bundles (they need the input-audio channel — use
 * ddsp_model_perform_audio). */
int ddsp_model_perform(ddsp_model *model, const float *pitch,
                       const float *loudness, float *out, int n);

/* Render n samples with an input-audio channel (mfcc-autoencoder bundles:
 * the causal MFCC feature source; output lags ONE block — the first block
 * returned is silence).  For decoder bundles the audio channel is ignored
 * and this behaves like ddsp_model_perform. */
int ddsp_model_perform_audio(ddsp_model *model, const float *pitch,
                             const float *loudness, const float *audio,
                             float *out, int n);

/* 1 if the loaded bundle consumes input audio (mfcc-autoencoder), 0 for
 * decoder bundles, -1 on a NULL model. */
int ddsp_model_needs_audio(const ddsp_model *model);

/* Model block size in samples (frame hop), or -1. */
int ddsp_model_block_size(const ddsp_model *model);

/* Model sample rate in Hz, or -1. */
int ddsp_model_sample_rate(const ddsp_model *model);

#ifdef __cplusplus
}
#endif

#endif /* DDSP_MODEL_H */
