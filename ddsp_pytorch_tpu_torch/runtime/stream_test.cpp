/* stream_test — pure-C++ unit test of the double-buffered engine.
 *
 * Uses a deterministic render callback (identity-delay on the pitch input)
 * to verify the 2*block pipeline invariant sample-exactly, plus worker
 * accounting and shutdown-while-inflight (the reference's free() leak —
 * SURVEY.md §5 — is the regression this guards).  Exits 0 on PASS.
 */

#include <chrono>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "ddsp_stream.h"

namespace {

int g_render_calls = 0;

void echo_render(const float *pitch, const float *loudness, float *out, int n,
                 void *) {
  // audio := pitch + loudness (pure, per-sample → exact expectations)
  for (int i = 0; i < n; ++i) out[i] = pitch[i] + loudness[i];
  ++g_render_calls;
}

void slow_render(const float *pitch, const float *, float *out, int n, void *) {
  std::this_thread::sleep_for(std::chrono::milliseconds(5));
  for (int i = 0; i < n; ++i) out[i] = pitch[i];
}

#define CHECK(cond)                                                        \
  do {                                                                     \
    if (!(cond)) {                                                         \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      return 1;                                                            \
    }                                                                      \
  } while (0)

int test_pipeline_exactness() {
  const int block = 64, tick = 16, n_ticks = 64;
  ddsp_stream_engine *e = ddsp_stream_create(block, echo_render, nullptr);
  CHECK(e != nullptr);
  CHECK(ddsp_stream_latency(e) == 2 * block);

  std::vector<float> in(n_ticks * tick), out(n_ticks * tick, -1.0f);
  for (size_t i = 0; i < in.size(); ++i) in[i] = (float)i;
  std::vector<float> loud(tick, 1.0f);

  for (int t = 0; t < n_ticks; ++t) {
    // give the worker time to finish the previous block (audio thread in a
    // real host runs at the sample rate; here we just yield)
    std::this_thread::sleep_for(std::chrono::microseconds(200));
    CHECK(ddsp_stream_process(e, in.data() + t * tick, loud.data(),
                              out.data() + t * tick, tick) == 0);
  }

  // First 2*block samples are the initial zero buffer; afterwards
  // out[i] == in[i - 2*block] + 1 (the echo render).
  for (int i = 0; i < 2 * block; ++i) CHECK(out[i] == 0.0f);
  for (size_t i = 2 * block; i < out.size(); ++i) {
    CHECK(out[i] == in[i - 2 * block] + 1.0f);
  }
  CHECK(ddsp_stream_blocks_rendered(e) >= n_ticks * tick / block - 1);
  // An underrun here means the worker woke later than 200 us after its
  // block: the host's scheduling, not the engine (the output above is exact
  // either way).  Reported, not asserted, so a loaded host cannot fail it.
  std::printf("stream_test: pipeline exactness underruns=%lld\n",
              (long long)ddsp_stream_underruns(e));
  ddsp_stream_destroy(e);
  return 0;
}

int test_bad_tick_rejected() {
  ddsp_stream_engine *e = ddsp_stream_create(64, echo_render, nullptr);
  float buf[48] = {0};
  CHECK(ddsp_stream_process(e, buf, buf, buf, 48) == -1);  // 48 ∤ 64
  ddsp_stream_destroy(e);
  return 0;
}

int test_slow_renderer_underrun_counted() {
  const int block = 32;
  ddsp_stream_engine *e = ddsp_stream_create(block, slow_render, nullptr);
  std::vector<float> buf(block, 0.0f);
  for (int t = 0; t < 8; ++t) {
    CHECK(ddsp_stream_process(e, buf.data(), buf.data(), buf.data(), block) ==
          0);
  }
  CHECK(ddsp_stream_underruns(e) > 0);  // 5ms render ≫ back-to-back ticks
  ddsp_stream_destroy(e);
  return 0;
}

int test_destroy_with_inflight_render() {
  const int block = 32;
  ddsp_stream_engine *e = ddsp_stream_create(block, slow_render, nullptr);
  std::vector<float> buf(block, 0.0f);
  ddsp_stream_process(e, buf.data(), buf.data(), buf.data(), block);
  ddsp_stream_destroy(e);  // must join cleanly mid-render
  return 0;
}

void echo_audio_render(const float *pitch, const float *loudness,
                       const float *audio, float *out, int n, void *) {
  // out := pitch + loudness + audio — proves the third ring reaches the
  // renderer with the same double-buffer alignment as the control rings
  for (int i = 0; i < n; ++i) out[i] = pitch[i] + loudness[i] + audio[i];
}

int test_audio_channel_pipeline() {
  const int block = 64, tick = 16, n_ticks = 64;
  ddsp_stream_engine *e =
      ddsp_stream_create_audio(block, echo_audio_render, nullptr);
  CHECK(e != nullptr);

  std::vector<float> in(n_ticks * tick), aud(n_ticks * tick),
      out(n_ticks * tick, -1.0f);
  for (size_t i = 0; i < in.size(); ++i) {
    in[i] = (float)i;
    aud[i] = 1000.0f + (float)i;  // distinct series per ring
  }
  std::vector<float> loud(tick, 1.0f);

  for (int t = 0; t < n_ticks; ++t) {
    std::this_thread::sleep_for(std::chrono::microseconds(200));
    CHECK(ddsp_stream_process_audio(e, in.data() + t * tick, loud.data(),
                                    aud.data() + t * tick,
                                    out.data() + t * tick, tick) == 0);
  }
  for (int i = 0; i < 2 * block; ++i) CHECK(out[i] == 0.0f);
  for (size_t i = 2 * block; i < out.size(); ++i) {
    CHECK(out[i] == in[i - 2 * block] + aud[i - 2 * block] + 1.0f);
  }
  ddsp_stream_destroy(e);

  // plain process on an audio engine: silent audio ring, still works
  e = ddsp_stream_create_audio(block, echo_audio_render, nullptr);
  std::vector<float> buf(block, 2.0f), out2(block, -1.0f);
  for (int t = 0; t < 4; ++t) {
    std::this_thread::sleep_for(std::chrono::microseconds(200));
    CHECK(ddsp_stream_process(e, buf.data(), buf.data(), out2.data(),
                              block) == 0);
  }
  CHECK(out2[0] == 4.0f);  // pitch 2 + loudness 2 + audio 0
  // audio-less ticks after audio ticks must NOT replay the stale ring:
  // two audio blocks, then plain ticks — the renderer must see zeros
  std::vector<float> aud2(block, 100.0f);
  for (int t = 0; t < 2; ++t) {
    std::this_thread::sleep_for(std::chrono::microseconds(200));
    CHECK(ddsp_stream_process_audio(e, buf.data(), buf.data(), aud2.data(),
                                    out2.data(), block) == 0);
  }
  for (int t = 0; t < 4; ++t) {
    std::this_thread::sleep_for(std::chrono::microseconds(200));
    CHECK(ddsp_stream_process(e, buf.data(), buf.data(), out2.data(),
                              block) == 0);
  }
  CHECK(out2[0] == 4.0f);  // NOT 104: stale audio was cleared
  ddsp_stream_destroy(e);
  return 0;
}

}  // namespace

int main() {
  if (test_pipeline_exactness()) return 1;
  if (test_bad_tick_rejected()) return 1;
  if (test_slow_renderer_underrun_counted()) return 1;
  if (test_destroy_with_inflight_render()) return 1;
  if (test_audio_channel_pipeline()) return 1;
  std::printf("stream_test: PASS (5 tests)\n");
  return 0;
}
