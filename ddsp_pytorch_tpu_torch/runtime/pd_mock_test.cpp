/* Mock-Pd host: loads the built ddsp~.pd_linux exactly the way Pure Data
 * does (dlopen + <name>_setup()), then drives the object through its whole
 * message/DSP lifecycle without a Pd installation:
 *
 *   setup → new → [load <bundle>] → dsp → perform × many ticks → free
 *
 * The handful of Pd API symbols the external imports (class_new, pd_new,
 * inlet/outlet, gensym, post, dsp_add, ...) are implemented here and made
 * visible to the dlopen'd module via -rdynamic (ENABLE_EXPORTS), which is
 * the same symbol-resolution scheme real Pd uses for externals.
 *
 * Role parity: the reference's ddsp~ is only ever tested by hand inside Pd
 * (SURVEY.md §4); this harness makes the path to the DAW testable in CI.
 *
 * Usage: pd_mock_test <path/to/ddsp~.pd_linux> [bundle_dir]
 *   without bundle_dir: asserts the unloaded object emits silence;
 *   with bundle_dir:    sends `load`, streams 220 Hz controls, asserts the
 *                       pipeline emits finite, non-silent audio after its
 *                       2-block latency and that re-`load` works.
 */

#include "pd/m_pd.h"

#include <dlfcn.h>

#include <cassert>
#include <cmath>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

/* ------------------------------------------------------------ Pd mock */

extern "C" {

t_symbol s_signal = {"signal", nullptr, nullptr};

struct _class {
  t_symbol *name;
  t_newmethod newmethod;
  t_method freemethod;
  size_t size;
  std::map<std::string, t_method> methods;
};

static std::map<std::string, t_symbol *> g_symtab;
static t_class *g_registered_class = nullptr;

t_symbol *gensym(const char *s) {
  auto it = g_symtab.find(s);
  if (it != g_symtab.end()) return it->second;
  auto *sym = new t_symbol{strdup(s), nullptr, nullptr};
  g_symtab[s] = sym;
  return sym;
}

t_class *class_new(t_symbol *name, t_newmethod newmethod, t_method freemethod,
                   size_t size, int /*flags*/, t_atomtype /*arg1*/, ...) {
  auto *c = new _class{name, newmethod, freemethod, size, {}};
  g_registered_class = c;
  return c;
}

void class_addmethod(t_class *c, t_method fn, t_symbol *sel,
                     t_atomtype /*arg1*/, ...) {
  c->methods[sel->s_name] = fn;
}

void class_domainsignalin(t_class * /*c*/, int /*onset*/) {}

t_pd *pd_new(t_class *c) {
  auto *obj = (t_pd *)calloc(1, c->size);
  *obj = c; /* ob_pd points at the class, like real Pd */
  return obj;
}

t_inlet *inlet_new(t_object * /*owner*/, t_pd * /*dest*/, t_symbol * /*s1*/,
                   t_symbol * /*s2*/) {
  return (t_inlet *)calloc(1, 16);
}
void inlet_free(t_inlet *x) { free(x); }

t_outlet *outlet_new(t_object * /*owner*/, t_symbol * /*s*/) {
  return (t_outlet *)calloc(1, 16);
}
void outlet_free(t_outlet *x) { free(x); }

void post(const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vprintf(fmt, ap);
  va_end(ap);
  printf("\n");
}

/* dsp_add: record the perform routine + its t_int args for the test loop
 * (real Pd appends to its DSP chain; one entry suffices here). */
static t_perfroutine g_perform = nullptr;
static std::vector<t_int> g_perform_args;

void dsp_add(t_perfroutine f, int n, ...) {
  g_perform = f;
  g_perform_args.assign(1, 0); /* slot 0 unused: Pd passes w where w[1] is the first arg */
  va_list ap;
  va_start(ap, n);
  for (int i = 0; i < n; i++) g_perform_args.push_back(va_arg(ap, t_int));
  va_end(ap);
}

} /* extern "C" */

/* -------------------------------------------------------------- driver */

int main(int argc, char **argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <ddsp~.pd_linux> [bundle_dir]\n", argv[0]);
    return 2;
  }
  const char *external_path = argv[1];
  const char *bundle = argc > 2 ? argv[2] : nullptr;

  /* 1. load the external the way Pd does */
  void *handle = dlopen(external_path, RTLD_NOW);
  if (!handle) {
    fprintf(stderr, "dlopen failed: %s\n", dlerror());
    return 1;
  }
  auto setup = (void (*)())dlsym(handle, "ddsp_tilde_setup");
  assert(setup && "ddsp_tilde_setup not exported");
  setup();
  assert(g_registered_class && "class_new not called");
  assert(std::string(g_registered_class->name->s_name) == "ddsp~");
  assert(g_registered_class->methods.count("load"));
  assert(g_registered_class->methods.count("dsp"));

  /* 2. instantiate (newmethod registered with A_DEFFLOAT) */
  auto newm = (void *(*)(t_floatarg))g_registered_class->newmethod;
  void *x = newm(0);
  assert(x && "new failed");

  /* 3. optional: load a bundle (twice: re-load must re-arm diagnostics) */
  if (bundle) {
    auto loadm =
        (void (*)(void *, t_symbol *))g_registered_class->methods["load"];
    loadm(x, gensym(bundle));
    loadm(x, gensym(bundle));
  }

  /* 4. wire DSP: 64-sample ticks (Pd's default vector size); inlets are
   * pitch, loudness, audio-in (the third inlet feeds mfcc-autoencoder
   * bundles; decoder bundles ignore it) then the outlet. */
  const int n = 64;
  std::vector<t_sample> pitch(n), loud(n), audio_in(n), out(n);
  t_signal sig_pitch{}, sig_loud{}, sig_audio{}, sig_out{};
  sig_pitch.s_n = sig_loud.s_n = sig_audio.s_n = sig_out.s_n = n;
  sig_pitch.s_vec = pitch.data();
  sig_loud.s_vec = loud.data();
  sig_audio.s_vec = audio_in.data();
  sig_out.s_vec = out.data();
  sig_pitch.s_sr = sig_loud.s_sr = sig_audio.s_sr = sig_out.s_sr = 48000;
  t_signal *sp[4] = {&sig_pitch, &sig_loud, &sig_audio, &sig_out};
  auto dspm = (void (*)(void *, t_signal **))g_registered_class->methods["dsp"];
  dspm(x, sp);
  assert(g_perform && "dsp_add not called");

  /* 5. perform loop: enough ticks to flush the 2-block pipeline latency */
  g_perform_args[1] = (t_int)x; /* as recorded, but be explicit */
  double energy = 0.0;
  int ticks = bundle ? 512 : 16;
  long sample_clock = 0;
  for (int t = 0; t < ticks; t++) {
    for (int i = 0; i < n; i++) {
      pitch[i] = 220.0f;
      loud[i] = 0.0f;
      /* 220 Hz sine on the audio inlet: autoencoder bundles re-synthesize
       * it, decoder bundles ignore it. */
      audio_in[i] =
          0.5f * sinf(2.0f * 3.14159265f * 220.0f *
                      (float)(sample_clock++) / 48000.0f);
    }
    t_int *ret = g_perform(g_perform_args.data());
    assert(ret == g_perform_args.data() + 7 && "perform must return w+7");
    for (int i = 0; i < n; i++) {
      assert(std::isfinite(out[i]) && "non-finite output sample");
      energy += (double)out[i] * out[i];
    }
  }
  if (bundle) {
    assert(energy > 0.0 && "loaded model produced pure silence");
  } else {
    assert(energy == 0.0 && "unloaded object must emit silence");
  }

  /* 6. free (joins the worker; must not hang or crash) */
  auto freem = (void (*)(void *))g_registered_class->freemethod;
  freem(x);
  free(x);

  printf("pd_mock_test ok (%s, energy=%.6f over %d ticks)\n",
         bundle ? "bundle" : "no model", energy, ticks);
  return 0;
}
