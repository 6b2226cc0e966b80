/* ddsp_stream.cpp — see ddsp_stream.h for the contract. */

#include "ddsp_stream.h"

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Engine {
  int block_size = 0;
  ddsp_render_fn render = nullptr;
  ddsp_render_audio_fn render_audio = nullptr;  // audio-channel variant
  void *ctx = nullptr;

  // Double buffer: two halves of 2*block_size rings.  The audio thread
  // fills half h with control input and reads audio from half h while the
  // worker renders half 1-h (same invariant as ddsp_tilde.cpp:75-95).
  std::vector<float> pitch_buf;     // 2 * block_size
  std::vector<float> loudness_buf;  // 2 * block_size
  std::vector<float> audio_buf;     // 2 * block_size (input audio ring)
  std::vector<float> out_buf;       // 2 * block_size
  int head = 0;

  // Worker handoff.
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  int pending_half = -1;  // half index to render, -1 = none
  bool done_rendering = true;
  bool stop = false;

  std::atomic<int64_t> blocks_rendered{0};
  std::atomic<int64_t> underruns{0};
};

void worker_main(Engine *e) {
  for (;;) {
    int half;
    {
      std::unique_lock<std::mutex> lock(e->mu);
      e->cv.wait(lock, [e] { return e->stop || e->pending_half >= 0; });
      if (e->stop && e->pending_half < 0) return;
      half = e->pending_half;
      e->pending_half = -1;
    }
    const int off = half * e->block_size;
    if (e->render_audio) {
      e->render_audio(e->pitch_buf.data() + off, e->loudness_buf.data() + off,
                      e->audio_buf.data() + off, e->out_buf.data() + off,
                      e->block_size, e->ctx);
    } else {
      e->render(e->pitch_buf.data() + off, e->loudness_buf.data() + off,
                e->out_buf.data() + off, e->block_size, e->ctx);
    }
    e->blocks_rendered.fetch_add(1, std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> lock(e->mu);
      e->done_rendering = true;
    }
    e->cv.notify_all();
  }
}

}  // namespace

extern "C" {

static ddsp_stream_engine *create_engine(int block_size, ddsp_render_fn render,
                                         ddsp_render_audio_fn render_audio,
                                         void *ctx) {
  if (block_size <= 0 || (render == nullptr && render_audio == nullptr))
    return nullptr;
  auto *e = new Engine();
  e->block_size = block_size;
  e->render = render;
  e->render_audio = render_audio;
  e->ctx = ctx;
  e->pitch_buf.assign(2 * block_size, 0.0f);
  e->loudness_buf.assign(2 * block_size, 0.0f);
  e->audio_buf.assign(2 * block_size, 0.0f);
  e->out_buf.assign(2 * block_size, 0.0f);
  e->worker = std::thread(worker_main, e);
  return reinterpret_cast<ddsp_stream_engine *>(e);
}

ddsp_stream_engine *ddsp_stream_create(int block_size, ddsp_render_fn render,
                                       void *ctx) {
  return create_engine(block_size, render, nullptr, ctx);
}

ddsp_stream_engine *ddsp_stream_create_audio(int block_size,
                                             ddsp_render_audio_fn render,
                                             void *ctx) {
  return create_engine(block_size, nullptr, render, ctx);
}

void ddsp_stream_destroy(ddsp_stream_engine *engine) {
  auto *e = reinterpret_cast<Engine *>(engine);
  if (!e) return;
  {
    std::lock_guard<std::mutex> lock(e->mu);
    e->stop = true;
  }
  e->cv.notify_all();
  if (e->worker.joinable()) e->worker.join();
  delete e;
}

int ddsp_stream_process_audio(ddsp_stream_engine *engine, const float *pitch,
                              const float *loudness, const float *audio,
                              float *out, int n) {
  auto *e = reinterpret_cast<Engine *>(engine);
  if (!e || n <= 0 || e->block_size % n != 0) return -1;

  std::memcpy(e->pitch_buf.data() + e->head, pitch, n * sizeof(float));
  std::memcpy(e->loudness_buf.data() + e->head, loudness, n * sizeof(float));
  if (audio) {
    std::memcpy(e->audio_buf.data() + e->head, audio, n * sizeof(float));
  } else {
    // audio-less tick = silent audio channel; never leave the previous
    // cycle's samples in the ring (a caller alternating process() and
    // process_audio() would otherwise replay stale input)
    std::memset(e->audio_buf.data() + e->head, 0, n * sizeof(float));
  }
  std::memcpy(out, e->out_buf.data() + e->head, n * sizeof(float));
  e->head += n;

  if (e->head % e->block_size == 0) {
    // The half just completed by the audio thread becomes the worker's
    // input; the worker writes audio in place, which the audio thread will
    // read one full cycle later (2*block latency, ddsp_tilde.cpp:81-95).
    const int completed_half = (e->head / e->block_size + 1) % 2;
    {
      std::unique_lock<std::mutex> lock(e->mu);
      if (!e->done_rendering) {
        e->underruns.fetch_add(1, std::memory_order_relaxed);
        e->cv.wait(lock, [e] { return e->done_rendering; });
      }
      e->done_rendering = false;
      e->pending_half = completed_half;
    }
    e->cv.notify_all();
    e->head = e->head % (2 * e->block_size);
  }
  return 0;
}

int ddsp_stream_process(ddsp_stream_engine *engine, const float *pitch,
                        const float *loudness, float *out, int n) {
  /* Plain tick: the audio ring region is zeroed (silent audio channel). */
  return ddsp_stream_process_audio(engine, pitch, loudness, nullptr, out, n);
}

int ddsp_stream_latency(const ddsp_stream_engine *engine) {
  auto *e = reinterpret_cast<const Engine *>(engine);
  return e ? 2 * e->block_size : 0;
}

int ddsp_stream_block(const ddsp_stream_engine *engine) {
  auto *e = reinterpret_cast<const Engine *>(engine);
  return e ? e->block_size : 0;
}

int64_t ddsp_stream_blocks_rendered(const ddsp_stream_engine *engine) {
  auto *e = reinterpret_cast<const Engine *>(engine);
  return e ? e->blocks_rendered.load(std::memory_order_relaxed) : 0;
}

int64_t ddsp_stream_underruns(const ddsp_stream_engine *engine) {
  auto *e = reinterpret_cast<const Engine *>(engine);
  return e ? e->underruns.load(std::memory_order_relaxed) : 0;
}

}  // extern "C"
