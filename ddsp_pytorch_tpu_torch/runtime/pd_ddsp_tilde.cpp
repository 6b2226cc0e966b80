/* ddsp~ — Pure Data external adapter over the native runtime.
 *
 * Role parity: realtime/ddsp_tilde/ddsp_tilde.cpp of the reference — a Pd
 * signal object with signal inlets for pitch (Hz) and loudness, one signal
 * outlet (audio), and a `load <bundle_dir>` message.  Re-designed on top of
 * this framework's engine + model host:
 *
 *   ddsp~ tick (64 samples) → ddsp_stream_process_audio (double-buffered
 *   pipeline, ddsp_stream.cpp) → worker thread → ddsp_model_perform_audio
 *   (CPython-embedded PyTorch streaming step on the CUDA card,
 *   ddsp_model.cpp)
 *
 * vs. the reference: the block pipeline joins its worker on free (the
 * reference leaks an in-flight std::thread, SURVEY.md §5), the model block
 * size comes from the loaded bundle instead of a compile-time B_SIZE, and a
 * THIRD signal inlet carries input audio so mfcc-autoencoder bundles do
 * DAW-side timbre transfer (the reference's external supports only the
 * decoder model; its autoencoder has no realtime path at all).  Decoder
 * bundles ignore the audio inlet, so 2-inlet patches keep working.
 *
 * Port of ddsp_pytorch_tpu/runtime/pd_ddsp_tilde.cpp.  Build: the Pd API
 * header is vendored at pd/m_pd.h (third-party, see pd/README.md) so
 * `ddsp~.pd_linux` builds unconditionally (runtime/__init__.py
 * build_runtime()).  Tested without Pd by the mock host
 * (pd_mock_test.cpp), which dlopens the built external exactly the way Pd
 * does.
 */

#include "m_pd.h"

#include <cstring>
#include <string>

#include "ddsp_model.h"
#include "ddsp_stream.h"

static t_class *ddsp_tilde_class;

struct t_ddsp_tilde {
  t_object x_obj;
  t_float f; /* dummy for CLASS_MAINSIGNALIN */

  t_inlet *in_loudness;
  t_inlet *in_audio; /* input audio (mfcc-autoencoder timbre transfer) */
  t_outlet *out_audio;

  ddsp_model *model;
  ddsp_stream_engine *engine;
  int process_error_posted; /* one-shot diagnostic for perform failures */
};

static void render_cb(const float *pitch, const float *loudness,
                      const float *audio, float *out, int n, void *ctx) {
  auto *model = static_cast<ddsp_model *>(ctx);
  /* perform_audio ignores the audio channel for decoder bundles and feeds
   * the MFCC encoder for autoencoder bundles (ddsp_model.h). */
  if (ddsp_model_perform_audio(model, pitch, loudness, audio, out, n) != 0) {
    std::memset(out, 0, n * sizeof(float));
  }
}

static void *ddsp_tilde_new() {
  auto *x = (t_ddsp_tilde *)pd_new(ddsp_tilde_class);
  x->in_loudness =
      inlet_new(&x->x_obj, &x->x_obj.ob_pd, &s_signal, &s_signal);
  x->in_audio = inlet_new(&x->x_obj, &x->x_obj.ob_pd, &s_signal, &s_signal);
  x->out_audio = outlet_new(&x->x_obj, &s_signal);
  x->model = nullptr;
  x->engine = nullptr;
  x->process_error_posted = 0;
  ddsp_runtime_init(nullptr);
  return (void *)x;
}

static void ddsp_tilde_free(t_ddsp_tilde *x) {
  if (x->engine) ddsp_stream_destroy(x->engine); /* joins the worker */
  if (x->model) ddsp_model_free(x->model);
  inlet_free(x->in_loudness);
  inlet_free(x->in_audio);
  outlet_free(x->out_audio);
}

static void ddsp_tilde_load(t_ddsp_tilde *x, t_symbol *sym) {
  if (x->engine) {
    ddsp_stream_destroy(x->engine);
    x->engine = nullptr;
  }
  if (x->model) {
    ddsp_model_free(x->model);
    x->model = nullptr;
  }
  x->model = ddsp_model_load(sym->s_name);
  x->process_error_posted = 0; /* re-arm the diagnostic for the new model */
  if (!x->model) {
    post("ddsp~: error loading bundle %s", sym->s_name);
    return;
  }
  const int block = ddsp_model_block_size(x->model);
  /* Render 2 model frames per engine block — same latency class as the
   * reference's B_SIZE=1024 at block_size=512.  The audio-channel engine
   * drives every bundle kind; decoder bundles just never read the ring. */
  x->engine = ddsp_stream_create_audio(2 * block, render_cb, x->model);
  post("ddsp~: loaded %s (sr=%d block=%d latency=%d samples%s)", sym->s_name,
       ddsp_model_sample_rate(x->model), block,
       ddsp_stream_latency(x->engine),
       ddsp_model_needs_audio(x->model) == 1
           ? ", autoencoder: audio inlet 3 active"
           : "");
}

static t_int *ddsp_tilde_perform(t_int *w) {
  auto *x = (t_ddsp_tilde *)(w[1]);
  auto *pitch = (t_sample *)(w[2]);
  auto *loudness = (t_sample *)(w[3]);
  auto *audio_in = (t_sample *)(w[4]);
  auto *out = (t_sample *)(w[5]);
  int n = (int)(w[6]);

  if (x->engine) {
    if (ddsp_stream_process_audio(x->engine, pitch, loudness, audio_in, out,
                                  n) != 0) {
      /* e.g. a patch reblocked so the tick no longer divides the engine
       * block: emit silence, never the stale contents of Pd's reused DSP
       * buffer, and say why once. */
      std::memset(out, 0, n * sizeof(float));
      if (!x->process_error_posted) {
        x->process_error_posted = 1;
        post("ddsp~: vector size %d incompatible with engine block %d — "
             "outputting silence (use a power-of-two block~ that divides "
             "the model block)",
             n, ddsp_stream_block(x->engine));
      }
    }
  } else {
    std::memset(out, 0, n * sizeof(float));
  }
  return (w + 7);
}

static void ddsp_tilde_dsp(t_ddsp_tilde *x, t_signal **sp) {
  /* s_n cast to t_int explicitly: varargs slots are pointer-sized and
   * d_ugen.c reads them back as t_int.  sp order: inlets (pitch, loudness,
   * audio-in) then the outlet. */
  dsp_add(ddsp_tilde_perform, 6, x, sp[0]->s_vec, sp[1]->s_vec, sp[2]->s_vec,
          sp[3]->s_vec, (t_int)sp[0]->s_n);
}

extern "C" {
void ddsp_tilde_setup(void) {
  ddsp_tilde_class =
      class_new(gensym("ddsp~"), (t_newmethod)ddsp_tilde_new,
                (t_method)ddsp_tilde_free, sizeof(t_ddsp_tilde),
                CLASS_DEFAULT, A_DEFFLOAT, 0);
  CLASS_MAINSIGNALIN(ddsp_tilde_class, t_ddsp_tilde, f);
  class_addmethod(ddsp_tilde_class, (t_method)ddsp_tilde_load, gensym("load"),
                  A_SYMBOL, 0);
  class_addmethod(ddsp_tilde_class, (t_method)ddsp_tilde_dsp, gensym("dsp"),
                  A_CANT, 0);
}
}
