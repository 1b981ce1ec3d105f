// biscuit_native: the host data plane of the PyTorch port.
//
// The port's copy of the JAX package's native/biscuit_native.cpp, with the
// same bn_* C interface, loaded through ctypes by
// biscuit_torch/data/native_loader.py, which builds it with g++ at first
// use:
//   * CRC32C (tfrecord framing checksums) - SSE4.2 hardware instruction
//     when the CPU has it, slicing-by-8 table otherwise.
//   * PNG/JPEG tile decode via libpng/libjpeg, each compiled in only where
//     its header is installed (bn_capabilities() says which are in); a
//     tile whose codec is not in is rejected, and callers decode it in
//     Python.
//   * TFRecord scanning/indexing.
//   * A threaded batch pipeline: record framing -> tf.train.Example proto
//     walk (image_raw/slide/loc fields) -> image decode, straight into a
//     caller-provided uint8 NHWC buffer with the GIL released.
//   * A tiled-TIFF region reader over libtiff, and JPEG2000 tiles through
//     OpenJPEG, both loaded with dlopen at first use: neither needs its
//     headers to build.
//
// C ABI throughout; no Python headers required. Built without
// -march=native, so one build runs on any x86-64 host.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cstdarg>
#include <string>
#include <thread>
#include <vector>
#include <atomic>
#include <mutex>
#include <algorithm>
#include <csetjmp>
#include <dlfcn.h>

// -DBN_HAVE_PNG=0 / -DBN_HAVE_JPEG=0 leave a codec out where its header
// is installed all the same.
#ifndef BN_HAVE_PNG
#if __has_include(<png.h>)
#define BN_HAVE_PNG 1
#else
#define BN_HAVE_PNG 0
#endif
#endif
#ifndef BN_HAVE_JPEG
#if __has_include(<jpeglib.h>)
#define BN_HAVE_JPEG 1
#else
#define BN_HAVE_JPEG 0
#endif
#endif
#if BN_HAVE_PNG
#include <png.h>
#endif
#if BN_HAVE_JPEG
#include <jpeglib.h>
#endif

// ---------------------------------------------------------------------------
// CRC32C
// ---------------------------------------------------------------------------

static uint32_t crc_table[8][256];
static bool crc_init_done = false;

static void crc32c_init() {
  const uint32_t poly = 0x82F63B78u;
  for (int i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    crc_table[0][i] = crc;
  }
  for (int i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      crc_table[t][i] =
          (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
  crc_init_done = true;
}

#if defined(__x86_64__)
#include <nmmintrin.h>
static bool has_sse42() {
  return __builtin_cpu_supports("sse4.2");
}
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(uint32_t crc, const uint8_t* data, size_t n) {
  while (n >= 8) {
    crc = (uint32_t)_mm_crc32_u64(crc, *(const uint64_t*)data);
    data += 8;
    n -= 8;
  }
  while (n--) crc = _mm_crc32_u8(crc, *data++);
  return crc;
}
#endif

static uint32_t crc32c_sw(uint32_t crc, const uint8_t* data, size_t n) {
  if (!crc_init_done) crc32c_init();
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, data, 8);
    v ^= crc;
    crc = crc_table[7][v & 0xFF] ^ crc_table[6][(v >> 8) & 0xFF] ^
          crc_table[5][(v >> 16) & 0xFF] ^ crc_table[4][(v >> 24) & 0xFF] ^
          crc_table[3][(v >> 32) & 0xFF] ^ crc_table[2][(v >> 40) & 0xFF] ^
          crc_table[1][(v >> 48) & 0xFF] ^ crc_table[0][(v >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n--) crc = crc_table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc;
}

extern "C" uint32_t bn_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
#if defined(__x86_64__)
  if (has_sse42()) return crc32c_hw(crc, data, n) ^ 0xFFFFFFFFu;
#endif
  return crc32c_sw(crc, data, n) ^ 0xFFFFFFFFu;
}

static uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = bn_crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng, memory source)
// ---------------------------------------------------------------------------

static const uint8_t kPngMagic[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A,
                                     0x0A};

#if BN_HAVE_PNG
struct MemReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

static void png_mem_read(png_structp png, png_bytep out, png_size_t count) {
  MemReader* r = (MemReader*)png_get_io_ptr(png);
  if (r->pos + count > r->size) png_error(png, "png: read past end");
  memcpy(out, r->data + r->pos, count);
  r->pos += count;
}

// Decode PNG to RGB8. Returns 0 on success. out must hold w*h*3.
static int decode_png(const uint8_t* buf, size_t n, uint8_t* out,
                      size_t out_cap, int* out_w, int* out_h) {
  if (n < 8 || png_sig_cmp(buf, 0, 8)) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  MemReader reader{buf, n, 0};
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  // Normalize everything to 8-bit RGB.
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  if ((size_t)w * h * 3 > out_cap) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *out_w = (int)w;
  *out_h = (int)h;
  return 0;
}
#endif  // BN_HAVE_PNG

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, memory source)
// ---------------------------------------------------------------------------

#if BN_HAVE_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = (JpegErr*)cinfo->err;
  longjmp(e->jb, 1);
}

static int decode_jpeg(const uint8_t* buf, size_t n, uint8_t* out,
                       size_t out_cap, int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, (unsigned long)n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  if ((size_t)w * h * 3 > out_cap) {
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  while ((int)cinfo.output_scanline < h) {
    uint8_t* row = out + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_w = w;
  *out_h = h;
  return 0;
}
#endif  // BN_HAVE_JPEG

// Returns 0 on success; -10 for an unknown format, -11 for a format whose
// codec was not built in.
extern "C" int bn_decode_image(const uint8_t* buf, size_t n, uint8_t* out,
                               size_t out_cap, int* w, int* h) {
  if (n >= 8 && !memcmp(buf, kPngMagic, 8)) {
#if BN_HAVE_PNG
    return decode_png(buf, n, out, out_cap, w, h);
#else
    return -11;
#endif
  }
  if (n >= 2 && buf[0] == 0xFF && buf[1] == 0xD8) {
#if BN_HAVE_JPEG
    return decode_jpeg(buf, n, out, out_cap, w, h);
#else
    return -11;
#endif
  }
  return -10;  // unknown format
}

// ---------------------------------------------------------------------------
// TFRecord scanning
// ---------------------------------------------------------------------------

// Index record offsets. Returns count, or -1 on I/O error, -2 if cap too
// small (call again with a larger buffer).
extern "C" long bn_index_tfrecord(const char* path, int64_t* offsets,
                                  long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long count = 0;
  int64_t pos = 0;
  uint8_t header[12];
  while (fread(header, 1, 12, f) == 12) {
    uint64_t len;
    memcpy(&len, header, 8);
    if (count < cap) offsets[count] = pos;
    ++count;
    if (fseek(f, (long)(len + 4), SEEK_CUR) != 0) break;
    pos += 8 + 4 + (int64_t)len + 4;
  }
  fclose(f);
  if (count > cap) return -2;
  return count;
}

// ---------------------------------------------------------------------------
// Minimal tf.train.Example walker: extract image_raw / slide / loc fields.
// ---------------------------------------------------------------------------

struct ProtoField {
  const uint8_t* data;
  size_t len;      // for length-delimited
  uint64_t varint; // for varint fields
};

static bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    result |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Walk a message, invoking fn(field_num, wire_type, field) per field.
template <typename Fn>
static bool walk(const uint8_t* p, const uint8_t* end, Fn fn) {
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    int field = (int)(tag >> 3);
    int wt = (int)(tag & 7);
    ProtoField pf{nullptr, 0, 0};
    if (wt == 0) {
      if (!read_varint(p, end, &pf.varint)) return false;
    } else if (wt == 2) {
      uint64_t len;
      if (!read_varint(p, end, &len)) return false;
      if (p + len > end) return false;
      pf.data = p;
      pf.len = (size_t)len;
      p += len;
    } else if (wt == 1) {
      if (p + 8 > end) return false;
      p += 8;
    } else if (wt == 5) {
      if (p + 4 > end) return false;
      p += 4;
    } else {
      return false;
    }
    fn(field, wt, pf);
  }
  return true;
}

struct TileFields {
  const uint8_t* image = nullptr;
  size_t image_len = 0;
  const uint8_t* slide = nullptr;
  size_t slide_len = 0;
  int64_t loc_x = 0, loc_y = 0, label = -1;
};

static void parse_example(const uint8_t* buf, size_t n, TileFields* out) {
  // Example { 1: Features { 1: map entry { 1: key, 2: Feature } } }
  walk(buf, buf + n, [&](int f1, int, ProtoField ex) {
    if (f1 != 1 || !ex.data) return;
    walk(ex.data, ex.data + ex.len, [&](int f2, int, ProtoField entry) {
      if (f2 != 1 || !entry.data) return;
      std::string key;
      const uint8_t* feat = nullptr;
      size_t feat_len = 0;
      walk(entry.data, entry.data + entry.len,
           [&](int f3, int, ProtoField kv) {
             if (f3 == 1 && kv.data)
               key.assign((const char*)kv.data, kv.len);
             else if (f3 == 2 && kv.data) {
               feat = kv.data;
               feat_len = kv.len;
             }
           });
      if (!feat) return;
      // Feature { 1: BytesList { 1: bytes }, 3: Int64List { 1: packed } }
      walk(feat, feat + feat_len, [&](int f4, int, ProtoField list) {
        if (!list.data) return;
        if (f4 == 1) {  // bytes_list
          walk(list.data, list.data + list.len,
               [&](int f5, int, ProtoField val) {
                 if (f5 != 1 || !val.data) return;
                 if (key == "image_raw") {
                   out->image = val.data;
                   out->image_len = val.len;
                 } else if (key == "slide") {
                   out->slide = val.data;
                   out->slide_len = val.len;
                 }
               });
        } else if (f4 == 3) {  // int64_list (packed)
          walk(list.data, list.data + list.len,
               [&](int f5, int wt5, ProtoField val) {
                 if (f5 != 1) return;
                 int64_t v = 0;
                 if (wt5 == 2 && val.data) {
                   const uint8_t* p = val.data;
                   uint64_t x;
                   if (read_varint(p, val.data + val.len, &x)) v = (int64_t)x;
                 } else if (wt5 == 0) {
                   v = (int64_t)val.varint;
                 }
                 if (key == "loc_x") out->loc_x = v;
                 else if (key == "loc_y") out->loc_y = v;
                 else if (key == "label") out->label = v;
               });
        }
      });
    });
  });
}

// ---------------------------------------------------------------------------
// Threaded batch read+decode
// ---------------------------------------------------------------------------

// Read `count` records of one tfrecord file at `offsets`, parse Examples,
// decode tiles into out (count, tile_px, tile_px, 3) uint8. Slides are
// written into slide_buf as fixed-width (slide_width) zero-padded strings.
// Returns number of successfully decoded tiles; tiles that fail decode or
// have mismatched size are zero-filled and their loc_x set to -1.
extern "C" long bn_read_decode_batch(
    const char* path, const int64_t* offsets, long count, int tile_px,
    uint8_t* out, char* slide_buf, int slide_width, int64_t* loc_out,
    int64_t* label_out, int verify_crc, int n_threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  // Read all requested records into memory (sequential I/O, one pass).
  std::vector<std::vector<uint8_t>> payloads((size_t)count);
  for (long i = 0; i < count; ++i) {
    if (fseek(f, (long)offsets[i], SEEK_SET) != 0) {
      fclose(f);
      return -1;
    }
    uint8_t header[12];
    if (fread(header, 1, 12, f) != 12) {
      fclose(f);
      return -1;
    }
    uint64_t len;
    memcpy(&len, header, 8);
    payloads[i].resize(len);
    if (fread(payloads[i].data(), 1, len, f) != len) {
      fclose(f);
      return -1;
    }
    if (verify_crc) {
      uint8_t crc_buf[4];
      if (fread(crc_buf, 1, 4, f) != 4) {
        fclose(f);
        return -1;
      }
      uint32_t expect;
      memcpy(&expect, crc_buf, 4);
      if (masked_crc(payloads[i].data(), len) != expect) {
        fclose(f);
        return -3;
      }
    }
  }
  fclose(f);

  const size_t tile_bytes = (size_t)tile_px * tile_px * 3;
  std::atomic<long> next(0), ok(0);
  int hw = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
  if (n_threads > count) n_threads = (int)count;
  if (n_threads < 1) n_threads = 1;

  auto worker = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= count) return;
      TileFields tf;
      parse_example(payloads[i].data(), payloads[i].size(), &tf);
      uint8_t* dst = out + (size_t)i * tile_bytes;
      bool good = false;
      if (tf.image) {
        int w = 0, h = 0;
        if (bn_decode_image(tf.image, tf.image_len, dst, tile_bytes, &w,
                            &h) == 0 &&
            w == tile_px && h == tile_px)
          good = true;
      }
      if (slide_buf) {
        char* s = slide_buf + (size_t)i * slide_width;
        memset(s, 0, slide_width);
        if (tf.slide) {
          size_t c = tf.slide_len < (size_t)slide_width - 1
                         ? tf.slide_len
                         : (size_t)slide_width - 1;
          memcpy(s, tf.slide, c);
        }
      }
      if (loc_out) {
        loc_out[2 * i] = good ? tf.loc_x : -1;
        loc_out[2 * i + 1] = tf.loc_y;
      }
      if (label_out) label_out[i] = tf.label;
      if (!good) {
        memset(dst, 0, tile_bytes);
        if (loc_out) loc_out[2 * i] = -1;
      } else {
        ok.fetch_add(1);
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return ok.load();
}


// ---------------------------------------------------------------------------
// JPEG2000 tile decode (OpenJPEG, loaded via dlopen)
//
// Aperio .svs levels use TIFF compression 33003 (J2K, YCbCr) / 33005
// (J2K, RGB) — raw JPEG2000 codestreams in TIFF tiles, which stock
// libtiff cannot decode (SURVEY §2.3 E3: the reference reads these via
// libvips/OpenSlide, which delegate to openjpeg). The system ships
// libopenjp2.so.7 but no headers, so the stable 2.x C ABI is declared
// here and the library is dlopen'd on first use; when it is absent the
// TIFF reader reports such files unsupported.
// ---------------------------------------------------------------------------

namespace opj {

// Subset of openjpeg.h (ABI stable across 2.1-2.5 / libopenjp2.so.7).
typedef struct {
  uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd, resno_decoded, factor;
  int32_t* data;
  uint16_t alpha;
} image_comp_t;

typedef struct {
  uint32_t x0, y0, x1, y1, numcomps;
  int32_t color_space;
  image_comp_t* comps;
  uint8_t* icc_profile_buf;
  uint32_t icc_profile_len;
} image_t;

enum { CODEC_J2K = 0, CODEC_JP2 = 2 };

typedef size_t (*stream_read_fn)(void*, size_t, void*);
typedef int64_t (*stream_skip_fn)(int64_t, void*);
typedef int (*stream_seek_fn)(int64_t, void*);
typedef void (*stream_free_fn)(void*);

struct Api {
  void* (*create_decompress)(int);
  void (*set_default_decoder_parameters)(void*);
  int (*setup_decoder)(void*, void*);
  void* (*stream_create)(size_t, int);
  void (*stream_set_read_function)(void*, stream_read_fn);
  void (*stream_set_skip_function)(void*, stream_skip_fn);
  void (*stream_set_seek_function)(void*, stream_seek_fn);
  void (*stream_set_user_data)(void*, void*, stream_free_fn);
  void (*stream_set_user_data_length)(void*, uint64_t);
  int (*read_header)(void*, void*, image_t**);
  int (*decode)(void*, void*, image_t*);
  int (*end_decompress)(void*, void*);
  void (*destroy_codec)(void*);
  void (*stream_destroy)(void*);
  void (*image_destroy)(image_t*);
};

static Api api;
static bool api_ready = false;

// ctypes releases the GIL, so two extraction threads can race into the
// first J2K decode: std::call_once makes the dlopen/dlsym fill of `api`
// happen-before every api_ready read (a plain tried/ready flag pair let
// a second thread observe tried==true with the struct half-written and
// misreport the slide as unsupported).
static std::once_flag api_once;

static void load_api_impl() {
  void* h = dlopen("libopenjp2.so.7", RTLD_NOW | RTLD_LOCAL);
  if (!h) h = dlopen("libopenjp2.so", RTLD_NOW | RTLD_LOCAL);
  if (!h) return;
  auto sym = [&](const char* n) { return dlsym(h, n); };
  api.create_decompress =
      (void* (*)(int))sym("opj_create_decompress");
  api.set_default_decoder_parameters =
      (void (*)(void*))sym("opj_set_default_decoder_parameters");
  api.setup_decoder = (int (*)(void*, void*))sym("opj_setup_decoder");
  api.stream_create = (void* (*)(size_t, int))sym("opj_stream_create");
  api.stream_set_read_function =
      (void (*)(void*, stream_read_fn))sym("opj_stream_set_read_function");
  api.stream_set_skip_function =
      (void (*)(void*, stream_skip_fn))sym("opj_stream_set_skip_function");
  api.stream_set_seek_function =
      (void (*)(void*, stream_seek_fn))sym("opj_stream_set_seek_function");
  api.stream_set_user_data =
      (void (*)(void*, void*, stream_free_fn))sym("opj_stream_set_user_data");
  api.stream_set_user_data_length =
      (void (*)(void*, uint64_t))sym("opj_stream_set_user_data_length");
  api.read_header = (int (*)(void*, void*, image_t**))sym("opj_read_header");
  api.decode = (int (*)(void*, void*, image_t*))sym("opj_decode");
  api.end_decompress = (int (*)(void*, void*))sym("opj_end_decompress");
  api.destroy_codec = (void (*)(void*))sym("opj_destroy_codec");
  api.stream_destroy = (void (*)(void*))sym("opj_stream_destroy");
  api.image_destroy = (void (*)(image_t*))sym("opj_image_destroy");
  api_ready = api.create_decompress && api.set_default_decoder_parameters &&
              api.setup_decoder && api.stream_create &&
              api.stream_set_read_function && api.stream_set_skip_function &&
              api.stream_set_seek_function && api.stream_set_user_data &&
              api.stream_set_user_data_length && api.read_header &&
              api.decode && api.end_decompress && api.destroy_codec &&
              api.stream_destroy && api.image_destroy;
}

static bool load_api() {
  std::call_once(api_once, load_api_impl);
  return api_ready;
}

struct MemStream {
  const uint8_t* buf;
  size_t size;
  size_t pos;
};

static size_t mem_read(void* out, size_t n, void* ud) {
  auto* m = static_cast<MemStream*>(ud);
  if (m->pos >= m->size) return (size_t)-1;
  size_t take = std::min(n, m->size - m->pos);
  memcpy(out, m->buf + m->pos, take);
  m->pos += take;
  return take;
}

static int64_t mem_skip(int64_t n, void* ud) {
  auto* m = static_cast<MemStream*>(ud);
  int64_t pos = (int64_t)m->pos + n;
  if (pos < 0) pos = 0;
  if (pos > (int64_t)m->size) pos = (int64_t)m->size;
  int64_t skipped = pos - (int64_t)m->pos;
  m->pos = (size_t)pos;
  return skipped ? skipped : -1;
}

static int mem_seek(int64_t n, void* ud) {
  auto* m = static_cast<MemStream*>(ud);
  if (n < 0 || n > (int64_t)m->size) return 0;
  m->pos = (size_t)n;
  return 1;
}

static inline uint8_t sample8(const image_comp_t& c, uint32_t x, uint32_t y) {
  uint32_t cx = std::min(x / std::max(c.dx, 1u), c.w ? c.w - 1 : 0);
  uint32_t cy = std::min(y / std::max(c.dy, 1u), c.h ? c.h - 1 : 0);
  int32_t v = c.data[(size_t)cy * c.w + cx];
  if (c.sgnd) v += 1 << (c.prec - 1);
  if (c.prec > 8) v >>= (c.prec - 8);
  return (uint8_t)std::max(0, std::min(255, v));
}

}  // namespace opj

// Decode one JPEG2000 codestream (raw J2K or JP2 box) into top-down RGB.
// ycbcr != 0 applies the JPEG full-range YCbCr->RGB transform (Aperio
// compression 33003; 33005 is RGB). Returns 0 and fills w/h on success.
extern "C" int bn_j2k_decode(const uint8_t* buf, int64_t n, uint8_t* out,
                             int64_t out_cap, int64_t* w, int64_t* h,
                             int32_t ycbcr) {
  if (!opj::load_api() || n < 12) return -1;
  static const uint8_t jp2_magic[] = {0x00, 0x00, 0x00, 0x0C, 0x6A, 0x50};
  int fmt = (memcmp(buf, jp2_magic, 6) == 0) ? opj::CODEC_JP2 : opj::CODEC_J2K;

  void* codec = opj::api.create_decompress(fmt);
  if (!codec) return -2;
  // opj_dparameters_t is ~10 KB (two 4096-char paths); a zeroed 64 KB
  // arena avoids declaring its layout while staying ABI-safe — the
  // library only ever writes within sizeof(opj_dparameters_t).
  std::vector<uint8_t> params(65536, 0);
  opj::api.set_default_decoder_parameters(params.data());
  if (!opj::api.setup_decoder(codec, params.data())) {
    opj::api.destroy_codec(codec);
    return -2;
  }
  void* stream = opj::api.stream_create(1 << 20, 1 /* input */);
  if (!stream) {
    opj::api.destroy_codec(codec);
    return -2;
  }
  opj::MemStream ms{buf, (size_t)n, 0};
  opj::api.stream_set_read_function(stream, opj::mem_read);
  opj::api.stream_set_skip_function(stream, opj::mem_skip);
  opj::api.stream_set_seek_function(stream, opj::mem_seek);
  opj::api.stream_set_user_data(stream, &ms, nullptr);
  opj::api.stream_set_user_data_length(stream, (uint64_t)n);

  opj::image_t* img = nullptr;
  int rc = -3;
  if (opj::api.read_header(stream, codec, &img) && img &&
      opj::api.decode(codec, stream, img)) {
    opj::api.end_decompress(codec, stream);
    uint32_t iw = img->x1 - img->x0, ih = img->y1 - img->y0;
    if (img->numcomps >= 1 && img->comps[0].data &&
        (int64_t)iw * ih * 3 <= out_cap) {
      const opj::image_comp_t* c = img->comps;
      bool gray = img->numcomps < 3 || !c[1].data || !c[2].data;
      for (uint32_t y = 0; y < ih; ++y) {
        uint8_t* dst = out + (size_t)y * iw * 3;
        for (uint32_t x = 0; x < iw; ++x, dst += 3) {
          if (gray) {
            uint8_t g = opj::sample8(c[0], x, y);
            dst[0] = dst[1] = dst[2] = g;
          } else if (ycbcr) {
            double Y = opj::sample8(c[0], x, y);
            double Cb = (double)opj::sample8(c[1], x, y) - 128.0;
            double Cr = (double)opj::sample8(c[2], x, y) - 128.0;
            auto clamp = [](double v) {
              return (uint8_t)std::max(0.0, std::min(255.0, v + 0.5));
            };
            dst[0] = clamp(Y + 1.402 * Cr);
            dst[1] = clamp(Y - 0.344136 * Cb - 0.714136 * Cr);
            dst[2] = clamp(Y + 1.772 * Cb);
          } else {
            dst[0] = opj::sample8(c[0], x, y);
            dst[1] = opj::sample8(c[1], x, y);
            dst[2] = opj::sample8(c[2], x, y);
          }
        }
      }
      *w = iw;
      *h = ih;
      rc = 0;
    }
  }
  if (img) opj::api.image_destroy(img);
  opj::api.stream_destroy(stream);
  opj::api.destroy_codec(codec);
  return rc;
}

// 1 if JPEG2000 decode is available (libopenjp2 found), else 0.
extern "C" int32_t bn_j2k_available() { return opj::load_api() ? 1 : 0; }

// ---------------------------------------------------------------------------
// Tiled-TIFF whole-slide region reader (libtiff, loaded via dlopen)
//
// Real WSI containers (.svs, generic pyramidal TIFF) are tiled TIFFs with
// JPEG-compressed tiles; loading them whole through PIL materializes a
// multi-gigapixel RGB image in host RAM. This reader decodes only the
// tiles intersecting a requested region, so extraction memory is bounded
// by the region size. Aperio's JPEG2000 variants (compression 33003/5)
// are routed through bn_j2k_decode (OpenJPEG) with raw tile reads; when
// libopenjp2 is unavailable they report as unsupported and the Python
// layer reads the file through PIL. Handles are not thread-safe
// (libtiff's TIFF* is stateful); use one handle per thread.
//
// libtiff's headers need not be installed: the few functions used here
// are declared below (TIFF* is opaque) and resolved from libtiff.so.6 at
// first use. Without the library every call reports the file unopenable.
// ---------------------------------------------------------------------------

namespace tiff {

struct TIFF;
typedef void (*ErrorHandler)(const char*, const char*, va_list);

enum : uint32_t {
  TAG_IMAGEWIDTH = 256,
  TAG_IMAGELENGTH = 257,
  TAG_BITSPERSAMPLE = 258,
  TAG_COMPRESSION = 259,
  TAG_PHOTOMETRIC = 262,
  TAG_IMAGEDESCRIPTION = 270,
  TAG_ORIENTATION = 274,
  TAG_SAMPLESPERPIXEL = 277,
  TAG_PLANARCONFIG = 284,
  TAG_TILEWIDTH = 322,
  TAG_TILELENGTH = 323,
  TAG_TILEBYTECOUNTS = 325,
  TAG_JPEGQUALITY = 65537,    // codec pseudo-tags
  TAG_JPEGCOLORMODE = 65538,
};
enum : uint16_t {
  COMPRESSION_NONE = 1,
  COMPRESSION_JPEG = 7,
  PHOTOMETRIC_RGB = 2,
  PHOTOMETRIC_YCBCR = 6,
  ORIENTATION_TOPLEFT = 1,
  PLANARCONFIG_CONTIG = 1,
  JPEGCOLORMODE_RGB = 1,
};

// Subset of tiffio.h (libtiff 4.x). TIFFSetDirectory's tdir_t is uint16
// before 4.5 and uint32 since; a uint32 argument serves both.
struct Api {
  ErrorHandler (*SetErrorHandler)(ErrorHandler);
  ErrorHandler (*SetWarningHandler)(ErrorHandler);
  TIFF* (*Open)(const char*, const char*);
  void (*Close)(TIFF*);
  int (*GetField)(TIFF*, uint32_t, ...);
  int (*SetField)(TIFF*, uint32_t, ...);
  int (*ReadDirectory)(TIFF*);
  int (*SetDirectory)(TIFF*, uint32_t);
  int (*IsTiled)(TIFF*);
  uint32_t (*ComputeTile)(TIFF*, uint32_t, uint32_t, uint32_t, uint16_t);
  uint64_t (*TileSize64)(TIFF*);
  int64_t (*ReadRawTile)(TIFF*, uint32_t, void*, int64_t);
  int (*ReadRGBATile)(TIFF*, uint32_t, uint32_t, uint32_t*);
  int64_t (*WriteTile)(TIFF*, void*, uint32_t, uint32_t, uint32_t, uint16_t);
};

static Api api;
static bool api_ready = false;
static bool tried_system = false;
// As for opj::api_once, threads race into the first use; a mutex rather
// than a once_flag, because bn_tiff_load may fill the API later.
static std::mutex api_mu;

// Fill `api` from the library handle h; true when every symbol is there.
static bool fill_api(void* h) {
  auto sym = [&](const char* n) { return dlsym(h, n); };
  api.SetErrorHandler = (ErrorHandler (*)(ErrorHandler))sym(
      "TIFFSetErrorHandler");
  api.SetWarningHandler = (ErrorHandler (*)(ErrorHandler))sym(
      "TIFFSetWarningHandler");
  api.Open = (TIFF* (*)(const char*, const char*))sym("TIFFOpen");
  api.Close = (void (*)(TIFF*))sym("TIFFClose");
  api.GetField = (int (*)(TIFF*, uint32_t, ...))sym("TIFFGetField");
  api.SetField = (int (*)(TIFF*, uint32_t, ...))sym("TIFFSetField");
  api.ReadDirectory = (int (*)(TIFF*))sym("TIFFReadDirectory");
  api.SetDirectory = (int (*)(TIFF*, uint32_t))sym("TIFFSetDirectory");
  api.IsTiled = (int (*)(TIFF*))sym("TIFFIsTiled");
  api.ComputeTile = (uint32_t (*)(TIFF*, uint32_t, uint32_t, uint32_t,
                                  uint16_t))sym("TIFFComputeTile");
  api.TileSize64 = (uint64_t (*)(TIFF*))sym("TIFFTileSize64");
  api.ReadRawTile = (int64_t (*)(TIFF*, uint32_t, void*, int64_t))sym(
      "TIFFReadRawTile");
  api.ReadRGBATile = (int (*)(TIFF*, uint32_t, uint32_t, uint32_t*))sym(
      "TIFFReadRGBATile");
  api.WriteTile = (int64_t (*)(TIFF*, void*, uint32_t, uint32_t, uint32_t,
                               uint16_t))sym("TIFFWriteTile");
  return api.SetErrorHandler && api.SetWarningHandler && api.Open &&
         api.Close && api.GetField && api.SetField && api.ReadDirectory &&
         api.SetDirectory && api.IsTiled && api.ComputeTile &&
         api.TileSize64 && api.ReadRawTile && api.ReadRGBATile &&
         api.WriteTile;
}

static bool open_lib(const char* name) {
  void* h = dlopen(name, RTLD_NOW | RTLD_LOCAL);
  if (!h) return false;
  if (fill_api(h)) return true;
  dlclose(h);
  return false;
}

// The system's libtiff, looked for once. -DBN_SYSTEM_TIFF=0 skips it (as
// on a host without it), leaving bn_tiff_load.
#ifndef BN_SYSTEM_TIFF
#define BN_SYSTEM_TIFF 1
#endif
static bool load_api() {
  std::lock_guard<std::mutex> lock(api_mu);
  if (!api_ready && !tried_system && BN_SYSTEM_TIFF) {
    tried_system = true;
    api_ready = open_lib("libtiff.so.6") || open_lib("libtiff.so") ||
                open_lib("libtiff.so.5");
  }
  return api_ready;
}

// Load libtiff from an explicit path (a copy that another package ships)
// where the system has none; 1 when the reader is then available.
static int32_t load_api_from(const char* path) {
  std::lock_guard<std::mutex> lock(api_mu);
  if (!api_ready) api_ready = open_lib(path);
  return api_ready ? 1 : 0;
}

// Open quietly (no stderr chatter); nullptr without libtiff or on failure.
static TIFF* open_quiet(const char* path, const char* mode) {
  if (!load_api()) return nullptr;
  api.SetErrorHandler(nullptr);
  api.SetWarningHandler(nullptr);
  return api.Open(path, mode);
}

static inline uint8_t R(uint32_t abgr) { return abgr & 0xff; }
static inline uint8_t G(uint32_t abgr) { return (abgr >> 8) & 0xff; }
static inline uint8_t B(uint32_t abgr) { return (abgr >> 16) & 0xff; }

}  // namespace tiff

// 1 if the tiled-TIFF reader is available (libtiff found), else 0.
extern "C" int32_t bn_tiff_available() { return tiff::load_api() ? 1 : 0; }

// Where the system has no libtiff: load the one at `path`; 1 on success.
extern "C" int32_t bn_tiff_load(const char* path) {
  if (tiff::load_api()) return 1;
  return tiff::load_api_from(path);
}

struct BnTiff {
  tiff::TIFF* tif;
  uint32_t width, height;
  uint32_t tile_w, tile_h;
  bool j2k;        // Aperio compression 33003/33005 -> OpenJPEG path
  bool j2k_ycbcr;  // 33003 stores YCbCr planes
};

// List pyramid levels (TIFF directories): fills widths/heights up to
// max_n, returns the directory count (or -1 if unopenable).
extern "C" int32_t bn_tiff_levels(const char* path, int64_t* widths,
                                  int64_t* heights, int32_t max_n) {
  using namespace tiff;
  TIFF* tif = open_quiet(path, "r");
  if (!tif) return -1;
  int32_t n = 0;
  do {
    uint32_t iw = 0, ih = 0;
    api.GetField(tif, TAG_IMAGEWIDTH, &iw);
    api.GetField(tif, TAG_IMAGELENGTH, &ih);
    if (n < max_n) {
      widths[n] = iw;
      heights[n] = ih;
    }
    ++n;
  } while (api.ReadDirectory(tif));
  api.Close(tif);
  return n;
}

// ImageDescription (tag 270) of directory 0 — carries Aperio's
// 'MPP = x' metadata. Returns the string length (truncated to cap-1), or
// -1 if the file is unopenable / has no description. Needed because PIL
// cannot even open J2K-compressed .svs files for metadata.
extern "C" int32_t bn_tiff_description(const char* path, char* buf,
                                      int32_t cap) {
  using namespace tiff;
  TIFF* tif = open_quiet(path, "r");
  if (!tif) return -1;
  char* desc = nullptr;
  int32_t len = -1;
  if (api.GetField(tif, TAG_IMAGEDESCRIPTION, &desc) && desc) {
    len = (int32_t)std::min<size_t>(strlen(desc), (size_t)cap - 1);
    memcpy(buf, desc, (size_t)len);
    buf[len] = 0;
  }
  api.Close(tif);
  return len;
}

extern "C" void* bn_tiff_open(const char* path, int32_t level, int64_t* w,
                              int64_t* h, int32_t* tile_w, int32_t* tile_h,
                              int32_t* supported) {
  using namespace tiff;
  *supported = 0;
  TIFF* tif = open_quiet(path, "r");
  if (!tif) return nullptr;
  if (level > 0 && !api.SetDirectory(tif, (uint32_t)level)) {
    api.Close(tif);
    return nullptr;
  }
  uint32_t iw = 0, ih = 0, tw = 0, th = 0;
  uint16_t compression = COMPRESSION_NONE;
  uint16_t photometric = PHOTOMETRIC_RGB;
  api.GetField(tif, TAG_IMAGEWIDTH, &iw);
  api.GetField(tif, TAG_IMAGELENGTH, &ih);
  api.GetField(tif, TAG_COMPRESSION, &compression);
  api.GetField(tif, TAG_PHOTOMETRIC, &photometric);
  bool tiled = api.IsTiled(tif);
  if (tiled) {
    api.GetField(tif, TAG_TILEWIDTH, &tw);
    api.GetField(tif, TAG_TILELENGTH, &th);
  }
  // 33003/33005: Aperio JPEG2000 — decoded via OpenJPEG from raw tiles
  // (33003 is YCbCr unless the photometric tag says otherwise, 33005 RGB).
  bool j2k = compression == 33003 || compression == 33005;
  bool ok = tiled && iw && ih && tw && th &&
            (!j2k || bn_j2k_available());
  *w = iw;
  *h = ih;
  *tile_w = tw;
  *tile_h = th;
  if (!ok) {
    api.Close(tif);
    return nullptr;
  }
  *supported = 1;
  bool ycbcr = j2k && (photometric == PHOTOMETRIC_YCBCR ||
                       (compression == 33003 &&
                        photometric != PHOTOMETRIC_RGB));
  auto* handle = new BnTiff{tif, iw, ih, tw, th, j2k, ycbcr};
  return handle;
}

extern "C" int bn_tiff_read_region(void* vh, int64_t x0, int64_t y0,
                                   int64_t rw, int64_t rh, uint8_t* out) {
  // out: (rh, rw, 3) RGB row-major, top-down. Out-of-image area is zero.
  using namespace tiff;
  auto* h = static_cast<BnTiff*>(vh);
  if (!h || rw <= 0 || rh <= 0) return -1;
  memset(out, 0, (size_t)rw * rh * 3);
  const int64_t tw = h->tile_w, th = h->tile_h;
  std::vector<uint32_t> tile;
  std::vector<uint8_t> rgb_tile, raw;
  if (h->j2k)
    rgb_tile.resize((size_t)tw * th * 3);
  else
    tile.resize((size_t)tw * th);
  int64_t tx0 = x0 < 0 ? (x0 - tw + 1) / tw : x0 / tw;
  int64_t ty0 = y0 < 0 ? (y0 - th + 1) / th : y0 / th;
  for (int64_t ty = ty0; ty * th < y0 + rh; ++ty) {
    if (ty < 0 || ty * th >= (int64_t)h->height) continue;
    for (int64_t tx = tx0; tx * tw < x0 + rw; ++tx) {
      if (tx < 0 || tx * tw >= (int64_t)h->width) continue;
      if (h->j2k) {
        // Raw codestream -> OpenJPEG. Decoded dims may be smaller than
        // (tw, th) at edge tiles; the zero fill above covers the rest.
        uint32_t tn = api.ComputeTile(h->tif, (uint32_t)(tx * tw),
                                      (uint32_t)(ty * th), 0, 0);
        int64_t rawsz = (int64_t)api.TileSize64(h->tif);
        uint64_t* counts = nullptr;
        if (api.GetField(h->tif, TAG_TILEBYTECOUNTS, &counts) && counts)
          rawsz = (int64_t)counts[tn];
        if (rawsz <= 0) return -2;
        raw.resize((size_t)rawsz);
        int64_t got = api.ReadRawTile(h->tif, tn, raw.data(), rawsz);
        if (got <= 0) return -2;
        memset(rgb_tile.data(), 0, rgb_tile.size());
        int64_t dw = 0, dh = 0;
        if (bn_j2k_decode(raw.data(), got, rgb_tile.data(),
                          (int64_t)rgb_tile.size(), &dw, &dh,
                          h->j2k_ycbcr ? 1 : 0) != 0 ||
            dw > tw || dh > th)
          return -2;
        int64_t gx0 = tx * tw, gy0 = ty * th;
        int64_t cx0 = std::max(gx0, x0), cx1 = std::min(gx0 + dw, x0 + rw);
        int64_t cy0 = std::max(gy0, y0), cy1 = std::min(gy0 + dh, y0 + rh);
        cx1 = std::min(cx1, (int64_t)h->width);
        cy1 = std::min(cy1, (int64_t)h->height);
        for (int64_t gy = cy0; gy < cy1; ++gy) {
          const uint8_t* src =
              rgb_tile.data() + (((gy - gy0) * dw) + (cx0 - gx0)) * 3;
          uint8_t* dst = out + (((gy - y0) * rw) + (cx0 - x0)) * 3;
          memcpy(dst, src, (size_t)(cx1 - cx0) * 3);
        }
        continue;
      }
      // TIFFReadRGBATile fills bottom-up ABGR; rows are flipped below.
      if (!api.ReadRGBATile(h->tif, (uint32_t)(tx * tw),
                            (uint32_t)(ty * th), tile.data()))
        return -2;
      int64_t gx0 = tx * tw, gy0 = ty * th;
      int64_t cx0 = std::max(gx0, x0), cx1 = std::min(gx0 + tw, x0 + rw);
      int64_t cy0 = std::max(gy0, y0), cy1 = std::min(gy0 + th, y0 + rh);
      cx1 = std::min(cx1, (int64_t)h->width);
      cy1 = std::min(cy1, (int64_t)h->height);
      for (int64_t gy = cy0; gy < cy1; ++gy) {
        // raster row for image row gy within this tile (bottom-up).
        int64_t in_row = th - 1 - (gy - gy0);
        const uint32_t* src = tile.data() + in_row * tw + (cx0 - gx0);
        uint8_t* dst = out + (((gy - y0) * rw) + (cx0 - x0)) * 3;
        for (int64_t gx = cx0; gx < cx1; ++gx, ++src, dst += 3) {
          uint32_t p = *src;
          dst[0] = R(p);
          dst[1] = G(p);
          dst[2] = B(p);
        }
      }
    }
  }
  return 0;
}

extern "C" void bn_tiff_close(void* vh) {
  auto* h = static_cast<BnTiff*>(vh);
  if (h) {
    tiff::api.Close(h->tif);
    delete h;
  }
}

// Tiled RGB TIFF writer (optionally JPEG-compressed, the .svs-style
// layout): test and smoke fixtures for the reader. append != 0 adds a
// directory (a pyramid level) to an existing file.
extern "C" int bn_tiff_write_tiled(const char* path, int64_t w, int64_t h,
                                   int32_t tw, int32_t th,
                                   const uint8_t* rgb, int use_jpeg,
                                   int append) {
  using namespace tiff;
  TIFF* tif = open_quiet(path, append ? "a" : "w");
  if (!tif) return -1;
  api.SetField(tif, TAG_IMAGEWIDTH, (uint32_t)w);
  api.SetField(tif, TAG_IMAGELENGTH, (uint32_t)h);
  api.SetField(tif, TAG_SAMPLESPERPIXEL, 3);
  api.SetField(tif, TAG_BITSPERSAMPLE, 8);
  api.SetField(tif, TAG_ORIENTATION, (int)ORIENTATION_TOPLEFT);
  api.SetField(tif, TAG_PLANARCONFIG, (int)PLANARCONFIG_CONTIG);
  api.SetField(tif, TAG_PHOTOMETRIC,
               (int)(use_jpeg ? PHOTOMETRIC_YCBCR : PHOTOMETRIC_RGB));
  api.SetField(tif, TAG_COMPRESSION,
               (int)(use_jpeg ? COMPRESSION_JPEG : COMPRESSION_NONE));
  if (use_jpeg) {
    api.SetField(tif, TAG_JPEGQUALITY, 90);
    // Input buffers are RGB; let the codec do the YCbCr conversion.
    api.SetField(tif, TAG_JPEGCOLORMODE, (int)JPEGCOLORMODE_RGB);
  }
  api.SetField(tif, TAG_TILEWIDTH, (uint32_t)tw);
  api.SetField(tif, TAG_TILELENGTH, (uint32_t)th);
  std::vector<uint8_t> tilebuf((size_t)tw * th * 3);
  for (int64_t ty = 0; ty < h; ty += th) {
    for (int64_t tx = 0; tx < w; tx += tw) {
      memset(tilebuf.data(), 0, tilebuf.size());
      for (int64_t y = ty; y < std::min<int64_t>(ty + th, h); ++y) {
        const uint8_t* src = rgb + (y * w + tx) * 3;
        int64_t ncols = std::min<int64_t>(tw, w - tx);
        memcpy(tilebuf.data() + (y - ty) * tw * 3, src, (size_t)ncols * 3);
      }
      if (api.WriteTile(tif, tilebuf.data(), (uint32_t)tx, (uint32_t)ty,
                        0, 0) < 0) {
        api.Close(tif);
        return -2;
      }
    }
  }
  api.Close(tif);
  return 0;
}

// Which parts are in: bit 0 PNG decode (libpng), bit 1 JPEG decode
// (libjpeg), bit 2 the tiled-TIFF reader (libtiff), bit 3 JPEG2000 tiles
// (OpenJPEG), bit 4 CRC32C on SSE4.2.
extern "C" int32_t bn_capabilities() {
  int32_t caps = (BN_HAVE_PNG ? 1 : 0) | (BN_HAVE_JPEG ? 2 : 0);
  if (tiff::load_api()) caps |= 4;
  if (opj::load_api()) caps |= 8;
#if defined(__x86_64__)
  if (has_sse42()) caps |= 16;
#endif
  return caps;
}

extern "C" const char* bn_version() { return "biscuit_native 0.1.0"; }
