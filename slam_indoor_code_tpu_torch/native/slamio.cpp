// slamio — native host-IO runtime: image decode + threaded prefetch ring.
//
// The reference's media ingest is OpenCV's imread/VideoCapture called
// synchronously inside the batch-fill loop (fillVideoFrameBatch,
// src/mainModule/cycleProcessing/batch.cpp:228-267 — decode+FAST measured at
// 123-440 ms per ~30-frame batch in its logs).  This library supplies the
// TPU framework's equivalent native component: RGB decode via libjpeg/libpng
// and an N-worker prefetcher that decodes ahead of the accelerator-feeding
// thread through a bounded, in-order frame queue (proper mutex/condvar — the
// reference's thread pool used a non-atomic flag busy-wait, SURVEY.md §5.2).
//
// C ABI only; Python binds via ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <csetjmp>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Frame {
  int h = 0, w = 0;
  std::vector<uint8_t> rgb;  // h*w*3 interleaved
  bool ok = false;
};

// ----------------------------------------------------------------- PNG
bool decode_png(const char* path, Frame* out) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  image.format = PNG_FORMAT_RGB;
  out->h = static_cast<int>(image.height);
  out->w = static_cast<int>(image.width);
  out->rgb.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out->rgb.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  out->ok = true;
  return true;
}

// ---------------------------------------------------------------- JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(const char* path, Frame* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = static_cast<int>(cinfo.output_height);
  out->w = static_cast<int>(cinfo.output_width);
  out->rgb.resize(static_cast<size_t>(out->h) * out->w * 3);
  const size_t stride = static_cast<size_t>(out->w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  out->ok = true;
  return true;
}

bool decode_any(const char* path, Frame* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  fclose(f);
  if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) return decode_png(path, out);
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) return decode_jpeg(path, out);
  // PPM P6 fallback (test fixtures)
  if (n >= 2 && magic[0] == 'P' && magic[1] == '6') {
    FILE* p = fopen(path, "rb");
    int w, h, maxv;
    if (fscanf(p, "P6 %d %d %d", &w, &h, &maxv) != 3) { fclose(p); return false; }
    fgetc(p);
    out->h = h; out->w = w;
    out->rgb.resize(static_cast<size_t>(h) * w * 3);
    size_t got = fread(out->rgb.data(), 1, out->rgb.size(), p);
    fclose(p);
    out->ok = got == out->rgb.size();
    return out->ok;
  }
  return false;
}

// -------------------------------------------------------- prefetch queue
struct Sequence {
  std::vector<std::string> paths;
  int capacity;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<int, Frame> ready;  // decoded frames by index
  int next_to_decode = 0;      // claimed by workers
  int next_to_emit = 0;        // consumer cursor
  bool stop = false;

  void worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        // bound decode-ahead to `capacity` frames beyond the consumer
        cv_space.wait(lk, [&] {
          return stop || (next_to_decode < static_cast<int>(paths.size()) &&
                          next_to_decode < next_to_emit + capacity);
        });
        if (stop || next_to_decode >= static_cast<int>(paths.size())) return;
        idx = next_to_decode++;
      }
      Frame fr;
      decode_any(paths[idx].c_str(), &fr);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(idx, std::move(fr));
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int slamio_decode_dims(const char* path, int* h, int* w) {
  Frame fr;
  if (!decode_any(path, &fr)) return -1;
  *h = fr.h;
  *w = fr.w;
  return 0;
}

int slamio_decode(const char* path, uint8_t* out, int64_t cap, int* h, int* w) {
  Frame fr;
  if (!decode_any(path, &fr)) return -1;
  if (static_cast<int64_t>(fr.rgb.size()) > cap) return -2;
  memcpy(out, fr.rgb.data(), fr.rgb.size());
  *h = fr.h;
  *w = fr.w;
  return 0;
}

void* slamio_open_sequence(const char** paths, int n, int capacity,
                           int nthreads) {
  auto* seq = new Sequence();
  seq->paths.assign(paths, paths + n);
  seq->capacity = capacity > 0 ? capacity : 8;
  int nt = nthreads > 0 ? nthreads : 2;
  for (int i = 0; i < nt; ++i)
    seq->workers.emplace_back([seq] { seq->worker(); });
  return seq;
}

// Returns 1 with a frame, 0 at end of sequence, -1 on decode failure of the
// next frame (skipped — call again), -2 if caller buffer too small.
int slamio_next(void* handle, uint8_t* out, int64_t cap, int* h, int* w) {
  auto* seq = static_cast<Sequence*>(handle);
  Frame fr;
  {
    std::unique_lock<std::mutex> lk(seq->mu);
    if (seq->next_to_emit >= static_cast<int>(seq->paths.size())) return 0;
    int want = seq->next_to_emit;
    seq->cv_ready.wait(lk, [&] { return seq->ready.count(want) > 0; });
    fr = std::move(seq->ready[want]);
    seq->ready.erase(want);
    seq->next_to_emit++;
  }
  seq->cv_space.notify_all();
  if (!fr.ok) return -1;
  if (static_cast<int64_t>(fr.rgb.size()) > cap) return -2;
  memcpy(out, fr.rgb.data(), fr.rgb.size());
  *h = fr.h;
  *w = fr.w;
  return 1;
}

void slamio_close(void* handle) {
  auto* seq = static_cast<Sequence*>(handle);
  {
    std::lock_guard<std::mutex> lk(seq->mu);
    seq->stop = true;
  }
  seq->cv_space.notify_all();
  seq->cv_ready.notify_all();
  for (auto& t : seq->workers) t.join();
  delete seq;
}

}  // extern "C"
