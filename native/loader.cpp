// Native data loader: the DevIL / GLTexInput::LoadImageFile analog
// (SURVEY.md §2.1 "GL texture wrapper" row ⚠), JAX edition.
//
// The reference decodes/converts images on the host before upload; this
// library does the same job as a multithreaded C++ pipeline feeding batched
// HBM tensors: PGM/PPM/BMP decode, RGB->luminance (0.299/0.587/0.114),
// 2x2 box pre-downsampling to a working-dimension cap (_texMaxDim analog),
// and letterbox placement into a fixed [H, W] frame slot.
//
// Exposed via a C ABI consumed with ctypes (core/native.py); no Python.h
// dependency.  Build: g++ -O3 -shared -fPIC loader.cpp -o libsiftloader.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<float> px;  // grayscale [h * w] in [0, 1]
  int h = 0, w = 0;
};

bool is_space(int c) { return c == ' ' || c == '\t' || c == '\r' || c == '\n'; }

// ---- PNM (P2/P3/P5/P6) ----
long pnm_token(const uint8_t* d, long len, long pos, long* out) {
  while (pos < len) {
    if (d[pos] == '#') {
      while (pos < len && d[pos] != '\n') pos++;
    } else if (is_space(d[pos])) {
      pos++;
    } else {
      break;
    }
  }
  long v = 0;
  bool any = false;
  while (pos < len && !is_space(d[pos]) && d[pos] != '#') {
    v = v * 10 + (d[pos] - '0');
    any = true;
    pos++;
  }
  *out = v;
  return any ? pos : -1;
}

bool decode_pnm(const uint8_t* d, long len, Image* img) {
  if (len < 2 || d[0] != 'P') return false;
  int kind = d[1] - '0';
  if (kind < 2 || kind > 6 || kind == 4) return false;
  bool binary = kind >= 5;
  int channels = (kind == 3 || kind == 6) ? 3 : 1;
  long pos = 2, w, h, maxv;
  if ((pos = pnm_token(d, len, pos, &w)) < 0) return false;
  if ((pos = pnm_token(d, len, pos, &h)) < 0) return false;
  if ((pos = pnm_token(d, len, pos, &maxv)) < 0) return false;
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 65535) return false;
  img->w = (int)w;
  img->h = (int)h;
  img->px.resize(w * h);
  const float lr = 0.299f, lg = 0.587f, lb = 0.114f;
  float scale = 1.0f / (float)maxv;
  long n = w * h;
  if (binary) {
    pos += 1;  // single whitespace after maxval
    int bytes = maxv > 255 ? 2 : 1;
    if (pos + n * channels * bytes > len) return false;
    const uint8_t* p = d + pos;
    for (long i = 0; i < n; i++) {
      float v[3];
      for (int c = 0; c < channels; c++) {
        long raw = bytes == 2 ? ((long)p[0] << 8 | p[1]) : p[0];
        p += bytes;
        v[c] = raw * scale;
      }
      img->px[i] = channels == 3 ? lr * v[0] + lg * v[1] + lb * v[2] : v[0];
    }
  } else {
    for (long i = 0; i < n; i++) {
      float v[3];
      for (int c = 0; c < channels; c++) {
        long t;
        if ((pos = pnm_token(d, len, pos, &t)) < 0) return false;
        v[c] = t * scale;
      }
      img->px[i] = channels == 3 ? lr * v[0] + lg * v[1] + lb * v[2] : v[0];
    }
  }
  return true;
}

// ---- BMP (uncompressed 8/24/32-bit) ----
uint32_t rd32(const uint8_t* p) {
  return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24;
}
uint16_t rd16(const uint8_t* p) { return p[0] | p[1] << 8; }

bool decode_bmp(const uint8_t* d, long len, Image* img) {
  if (len < 54 || d[0] != 'B' || d[1] != 'M') return false;
  uint32_t off = rd32(d + 10);
  int32_t w = (int32_t)rd32(d + 18);
  int32_t h = (int32_t)rd32(d + 22);
  uint16_t bpp = rd16(d + 28);
  uint32_t comp = rd32(d + 30);
  if (comp != 0 || w <= 0 || h == 0) return false;
  bool flip = h > 0;
  int ah = h > 0 ? h : -h;
  if (bpp != 8 && bpp != 24 && bpp != 32) return false;
  long stride = ((w * bpp / 8) + 3) & ~3L;
  if (off + stride * ah > len) return false;
  img->w = w;
  img->h = ah;
  img->px.resize((long)w * ah);
  const float lr = 0.299f, lg = 0.587f, lb = 0.114f;
  for (int y = 0; y < ah; y++) {
    const uint8_t* row = d + off + stride * (flip ? (ah - 1 - y) : y);
    float* out = img->px.data() + (long)y * w;
    if (bpp == 8) {
      for (int x = 0; x < w; x++) out[x] = row[x] / 255.0f;
    } else {
      int step = bpp / 8;
      for (int x = 0; x < w; x++) {  // BGR order
        const uint8_t* p = row + x * step;
        out[x] = (lb * p[0] + lg * p[1] + lr * p[2]) / 255.0f;
      }
    }
  }
  return true;
}

bool decode_any(const uint8_t* d, long len, Image* img) {
  if (len >= 2 && d[0] == 'P') return decode_pnm(d, len, img);
  if (len >= 2 && d[0] == 'B' && d[1] == 'M') return decode_bmp(d, len, img);
  return false;
}

// 2x2 box downsample until max(h, w) <= maxd (the -maxd pre-downsample ⚠)
void downsample_to_fit(Image* img, int maxd) {
  while (maxd > 0 && (img->h > maxd || img->w > maxd)) {
    int h2 = img->h / 2, w2 = img->w / 2;
    if (h2 < 1 || w2 < 1) break;
    std::vector<float> out((long)h2 * w2);
    for (int y = 0; y < h2; y++)
      for (int x = 0; x < w2; x++) {
        const float* r0 = img->px.data() + (long)(2 * y) * img->w + 2 * x;
        const float* r1 = r0 + img->w;
        out[(long)y * w2 + x] = 0.25f * (r0[0] + r0[1] + r1[0] + r1[1]);
      }
    img->px.swap(out);
    img->h = h2;
    img->w = w2;
  }
}

bool load_file(const char* path, Image* img) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len);
  bool ok = fread(buf.data(), 1, len, f) == (size_t)len;
  fclose(f);
  return ok && decode_any(buf.data(), len, img);
}

}  // namespace

extern "C" {

// Decode one file to grayscale float. Returns 0 on success; *h/*w receive
// the (possibly downsampled) size; out must hold out_cap floats.
int sift_load_image(const char* path, int maxd, float* out, long out_cap,
                    int* h, int* w) {
  Image img;
  if (!load_file(path, &img)) return 1;
  downsample_to_fit(&img, maxd);
  if ((long)img.px.size() > out_cap) return 2;
  memcpy(out, img.px.data(), img.px.size() * sizeof(float));
  *h = img.h;
  *w = img.w;
  return 0;
}

// Multithreaded batch loader: decode n files in parallel, place each frame
// into out[i] ([H, W] slot, top-left anchored, zero padded / cropped).
// status[i]: 0 ok, nonzero error. Returns number of failures.
int sift_load_batch(const char** paths, int n, int maxd, int H, int W,
                    float* out, int* status, int num_threads) {
  if (num_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    num_threads = hc ? (int)hc : 4;
  }
  if (num_threads > n) num_threads = n > 0 ? n : 1;
  std::vector<std::thread> workers;
  for (int tid = 0; tid < num_threads; tid++) {
    workers.emplace_back([&, tid]() {
      for (int i = tid; i < n; i += num_threads) {
        Image img;
        if (!load_file(paths[i], &img)) {
          status[i] = 1;
          continue;
        }
        downsample_to_fit(&img, maxd);
        float* slot = out + (long)i * H * W;
        memset(slot, 0, (long)H * W * sizeof(float));
        int ch = img.h < H ? img.h : H;
        int cw = img.w < W ? img.w : W;
        for (int y = 0; y < ch; y++)
          memcpy(slot + (long)y * W, img.px.data() + (long)y * img.w,
                 cw * sizeof(float));
        status[i] = 0;
      }
    });
  }
  for (auto& t : workers) t.join();
  int fails = 0;
  for (int i = 0; i < n; i++) fails += status[i] != 0;
  return fails;
}

// Feature-store writers (SaveSIFT analog ⚠): VisualSFM-style binary layout.
int sift_write_binary(const char* path, int n, const float* keys /*[n,4]*/,
                      const uint8_t* desc /*[n,128]*/) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  int32_t hdr[5];
  memcpy(&hdr[0], "SIFT", 4);
  memcpy(&hdr[1], "V4.0", 4);
  hdr[2] = n;
  hdr[3] = 5;
  hdr[4] = 128;
  fwrite(hdr, 4, 5, f);
  for (int i = 0; i < n; i++) {
    float loc[5] = {keys[i * 4 + 0], keys[i * 4 + 1], 0.0f, keys[i * 4 + 2],
                    keys[i * 4 + 3]};
    fwrite(loc, 4, 5, f);
  }
  fwrite(desc, 1, (long)n * 128, f);
  int32_t eof_marker;
  memcpy(&eof_marker, "EOF\0", 4);
  fwrite(&eof_marker, 4, 1, f);
  fclose(f);
  return 0;
}

}  // extern "C"
