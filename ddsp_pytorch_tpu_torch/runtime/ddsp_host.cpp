/* ddsp_host — standalone realtime host: bundle + stream engine.
 *
 * Role parity: what the reference's Pd external does end-to-end (load a
 * deployed model, feed pitch/loudness in audio-callback-sized ticks through
 * the double-buffered pipeline, collect audio), minus Pd itself: control
 * input comes from the command line / a generator, audio goes to a wav.
 *
 * Usage:
 *   ddsp_host <bundle_dir> [seconds] [tick_size] [repo_root]
 *
 * Reports per-tick timing, pipeline latency, underruns — the native-side
 * realtime benchmark (reference performance.py measured only the model
 * call; this measures the full host path).  The ticks are not paced: the
 * audio thread pushes them back to back, so the wall time is the host
 * path's throughput and `underruns` counts the ticks that waited on the
 * worker (runtime/selftest.py --soak paces ticks in real time).
 *
 * Port of ddsp_pytorch_tpu/runtime/ddsp_host.cpp: the model host
 * (ddsp_model.h) renders through the PyTorch session on DDSP_DEVICE
 * (default cuda).  Writes ddsp_host_out.wav to the working directory.
 */

#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "ddsp_model.h"
#include "ddsp_stream.h"

namespace {

struct RenderCtx {
  ddsp_model *model;
  bool needs_audio = false;  // mfcc-autoencoder bundle
  long pos = 0;              // sample counter for the synthetic input feed
  int sr = 48000;
  std::vector<float> audio_in;
};

void render_cb(const float *pitch, const float *loudness, float *out, int n,
               void *ctx) {
  auto *rc = static_cast<RenderCtx *>(ctx);
  int err;
  if (rc->needs_audio) {
    // Stand-in for the live input feed (mic / DAW bus): a 220 Hz tone.
    // Blocks arrive in order on the engine's single worker thread, so the
    // position counter needs no synchronization.
    rc->audio_in.resize(n);
    for (int i = 0; i < n; ++i) {
      double t = (double)(rc->pos + i) / rc->sr;
      rc->audio_in[i] = 0.5f * (float)std::sin(2.0 * M_PI * 220.0 * t);
    }
    rc->pos += n;
    err = ddsp_model_perform_audio(rc->model, pitch, loudness,
                                   rc->audio_in.data(), out, n);
  } else {
    err = ddsp_model_perform(rc->model, pitch, loudness, out, n);
  }
  if (err != 0) std::memset(out, 0, n * sizeof(float));
}

void write_wav(const char *path, const std::vector<float> &audio, int sr) {
  std::FILE *f = std::fopen(path, "wb");
  if (!f) return;
  const uint32_t data_bytes = (uint32_t)(audio.size() * 2);
  const uint32_t chunk = 36 + data_bytes;
  const uint16_t fmt = 1, channels = 1, bits = 16;
  const uint32_t byte_rate = (uint32_t)sr * 2;
  const uint16_t block_align = 2;
  std::fwrite("RIFF", 1, 4, f);
  std::fwrite(&chunk, 4, 1, f);
  std::fwrite("WAVEfmt ", 1, 8, f);
  const uint32_t fmt_size = 16;
  std::fwrite(&fmt_size, 4, 1, f);
  std::fwrite(&fmt, 2, 1, f);
  std::fwrite(&channels, 2, 1, f);
  std::fwrite(&sr, 4, 1, f);
  std::fwrite(&byte_rate, 4, 1, f);
  std::fwrite(&block_align, 2, 1, f);
  std::fwrite(&bits, 2, 1, f);
  std::fwrite("data", 1, 4, f);
  std::fwrite(&data_bytes, 4, 1, f);
  for (float s : audio) {
    float c = s < -1.f ? -1.f : (s > 1.f ? 1.f : s);
    int16_t v = (int16_t)(c * 32767.f);
    std::fwrite(&v, 2, 1, f);
  }
  std::fclose(f);
}

}  // namespace

int main(int argc, char **argv) {
  if (argc < 2) {
    std::fprintf(stderr,
                 "usage: %s <bundle_dir> [seconds] [tick] [repo_root]\n",
                 argv[0]);
    return 2;
  }
  const char *bundle = argv[1];
  const double seconds = argc > 2 ? std::atof(argv[2]) : 2.0;
  const int tick = argc > 3 ? std::atoi(argv[3]) : 64;
  const char *repo_root = argc > 4 ? argv[4] : ".";

  if (ddsp_runtime_init(repo_root) != 0) return 1;
  ddsp_model *model = ddsp_model_load(bundle);
  if (!model) return 1;
  const int sr = ddsp_model_sample_rate(model);
  const int block = ddsp_model_block_size(model);
  const bool needs_audio = ddsp_model_needs_audio(model) == 1;
  std::printf("loaded bundle: sr=%d block=%d%s\n", sr, block,
              needs_audio ? " (mfcc-autoencoder: audio channel on)" : "");

  // Warm up outside the timed loop: the first call loads the kernel's
  // library and creates the card's handles.
  {
    std::vector<float> p(block, 220.f), l(block, 0.f), o(block, 0.f);
    if (needs_audio) {
      std::vector<float> a(block, 0.f);
      ddsp_model_perform_audio(model, p.data(), l.data(), a.data(), o.data(),
                               block);
    } else {
      ddsp_model_perform(model, p.data(), l.data(), o.data(), block);
    }
  }

  RenderCtx ctx{model};
  ctx.needs_audio = needs_audio;
  ctx.sr = sr;
  ddsp_stream_engine *eng = ddsp_stream_create(block, render_cb, &ctx);

  const long total = (long)(seconds * sr) / tick * tick;
  std::vector<float> pitch(tick), loud(tick, 0.0f), out(tick);
  std::vector<float> audio;
  audio.reserve(total);

  double worst_tick_us = 0.0;
  auto t0 = std::chrono::steady_clock::now();
  for (long s = 0; s < total; s += tick) {
    for (int i = 0; i < tick; ++i) {
      double t = (double)(s + i) / sr;
      pitch[i] = 220.0f + 110.0f * (float)std::sin(2.0 * M_PI * 0.5 * t);
      loud[i] = 0.0f;
    }
    auto a = std::chrono::steady_clock::now();
    ddsp_stream_process(eng, pitch.data(), loud.data(), out.data(), tick);
    auto b = std::chrono::steady_clock::now();
    double us = std::chrono::duration<double, std::micro>(b - a).count();
    if (us > worst_tick_us) worst_tick_us = us;
    audio.insert(audio.end(), out.begin(), out.end());
  }
  auto t1 = std::chrono::steady_clock::now();
  double wall = std::chrono::duration<double>(t1 - t0).count();
  double realtime = seconds / wall;

  std::printf("rendered %.2fs in %.2fs (%.2fx realtime through host path)\n",
              seconds, wall, realtime);
  std::printf("pipeline latency: %d samples (%.1f ms)\n",
              ddsp_stream_latency(eng), 1000.0 * ddsp_stream_latency(eng) / sr);
  std::printf("blocks rendered: %lld, underruns: %lld\n",
              (long long)ddsp_stream_blocks_rendered(eng),
              (long long)ddsp_stream_underruns(eng));
  std::printf("worst audio-thread tick: %.1f us (budget %.1f us)\n",
              worst_tick_us, 1e6 * tick / sr);

  write_wav("ddsp_host_out.wav", audio, sr);
  std::printf("wrote ddsp_host_out.wav\n");

  ddsp_stream_destroy(eng);
  ddsp_model_free(model);
  return 0;
}
