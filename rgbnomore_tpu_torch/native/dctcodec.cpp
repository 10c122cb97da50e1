// dctcodec — host-side JPEG DCT coefficient codec for the TPU pipeline.
//
// CPython extension (no pybind11/numpy C-API): functions speak Python
// bytes / buffer-protocol objects; the thin numpy wrapper lives in
// rgbnomore_tpu/codec.py.
//
// Capability parity with the reference extension dct_manip/dct_manip.cpp
// (JeongsooP/RGB-no-more), re-implemented from the libjpeg API directly:
//   read_coefficients     (dct_manip.cpp:152-178)  header+Huffman decode only
//   read_into_canvas      (new, TPU hot path)      decode into caller canvas
//   write_coefficients    (dct_manip.cpp:265-313)
//   quantize_at_quality   (dct_manip.cpp:315-375)
//   write_tensor          (dct_manip.cpp:377-424)
//   read_jpeg             (dct_manip.cpp:426-483)
//   decode_coeff          (dct_manip.cpp:485-576)
//
// The hot function (read_into_canvas) releases the GIL around all libjpeg
// work so a thread-pool loader scales across host cores.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <csetjmp>
#include <cstring>
#include <functional>
#include <atomic>
#include <cstdint>
#include <ctime>
#include <string>
#include <vector>

#include <jpeglib.h>

// AVX-512 fast path for the hot crop-wire packer (pack_block_topk_mask16_f32).
// The build is -march=native with a host-CPU-keyed cache (native/build.py), so
// compile-time dispatch is safe: the .so never runs on a CPU it wasn't built
// for.  VBMI2 supplies byte compress (vpcompressb), BMI2 supplies PDEP for the
// tie-quota mask.
#if defined(__AVX512F__) && defined(__AVX512BW__) && \
    defined(__AVX512VBMI2__) && defined(__BMI2__)
#include <immintrin.h>
#define DCTCODEC_AVX512_PACK 1
#endif

namespace {

constexpr int kDct = DCTSIZE;       // 8
constexpr int kDct2 = DCTSIZE2;     // 64

// ---------------------------------------------------------------------------
// Error handling: libjpeg is C, so we longjmp out of its error callback and
// surface the message as a Python RuntimeError.
// ---------------------------------------------------------------------------
struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
  char message[JMSG_LENGTH_MAX];
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->jump, 1);
}

long div_round_up(long a, long b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Optional stage profiler for the crop-before-pack path.  Thread-local ns
// accumulators, enabled only when crop_profile(1) was called — zero cost on
// the production path (a single relaxed bool test per stage).
// ---------------------------------------------------------------------------
struct CropProf {
  std::atomic<uint64_t> decode{0}, extract_resize{0}, pack{0}, n{0};
};
std::atomic<bool> g_prof_enabled{false};
CropProf g_prof;

inline uint64_t prof_now() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

// ---------------------------------------------------------------------------
// Core decode: entropy-decode DCT coefficients from an initialized
// decompress struct into caller-provided storage.
// ---------------------------------------------------------------------------
struct CoeffInfo {
  int num_components = 0;
  // per component: blocks and downsampled pixel dims
  int height_in_blocks[3] = {0, 0, 0};
  int width_in_blocks[3] = {0, 0, 0};
  int down_h[3] = {0, 0, 0};
  int down_w[3] = {0, 0, 0};
};

// Copies component compNum's blocks into `out` laid out
// (height_in_blocks, width_in_blocks, 8, 8) int16, with row stride
// canvas_w blocks (>= width_in_blocks).  Rows/cols beyond the image are the
// caller's responsibility (canvas pre-zeroing).
void extract_component(jpeg_decompress_struct& cinfo, jvirt_barray_ptr* arrays,
                       int comp, int16_t* out, int canvas_h, int canvas_w) {
  const int hb = std::min<int>(cinfo.comp_info[comp].height_in_blocks, canvas_h);
  const int wb = std::min<int>(cinfo.comp_info[comp].width_in_blocks, canvas_w);
  for (int row = 0; row < hb; ++row) {
    JBLOCKARRAY row_ptrs = (*cinfo.mem->access_virt_barray)(
        reinterpret_cast<j_common_ptr>(&cinfo), arrays[comp], row, 1, FALSE);
    int16_t* dst = out + static_cast<size_t>(row) * canvas_w * kDct2;
    for (int b = 0; b < wb; ++b) {
      std::memcpy(dst + static_cast<size_t>(b) * kDct2, row_ptrs[0][b],
                  kDct2 * sizeof(int16_t));
    }
  }
}

void extract_quant(jpeg_decompress_struct& cinfo, int comp, int16_t* out) {
  JQUANT_TBL* tbl = cinfo.comp_info[comp].quant_table;
  if (tbl == nullptr) tbl = cinfo.quant_tbl_ptrs[cinfo.comp_info[comp].quant_tbl_no];
  if (tbl == nullptr) {
    for (int i = 0; i < kDct2; ++i) out[i] = 1;
    return;
  }
  // a zero entry (a malformed DQT) reads as 1: requant_plane divides by it
  for (int i = 0; i < kDct2; ++i)
    out[i] = static_cast<int16_t>(tbl->quantval[i] == 0 ? 1 : tbl->quantval[i]);
}

// Reads coefficients; caller must already have called jpeg_read_header.
// `y` must hold y_canvas_h*y_canvas_w blocks; `c` (may be null)
// 2*c_canvas_h*c_canvas_w blocks; `quant` 3*64 int16.
bool decode_coefficients(jpeg_decompress_struct& cinfo, CoeffInfo* info,
                         int16_t* y, int y_canvas_h, int y_canvas_w,
                         int16_t* c, int c_canvas_h, int c_canvas_w,
                         int16_t* quant) {
  jvirt_barray_ptr* arrays = jpeg_read_coefficients(&cinfo);

  info->num_components = cinfo.num_components;
  for (int i = 0; i < cinfo.num_components && i < 3; ++i) {
    info->height_in_blocks[i] = cinfo.comp_info[i].height_in_blocks;
    info->width_in_blocks[i] = cinfo.comp_info[i].width_in_blocks;
    info->down_h[i] = cinfo.comp_info[i].downsampled_height;
    info->down_w[i] = cinfo.comp_info[i].downsampled_width;
  }

  extract_component(cinfo, arrays, 0, y, y_canvas_h, y_canvas_w);
  extract_quant(cinfo, 0, quant);

  if (cinfo.num_components > 1 && c != nullptr) {
    const size_t plane = static_cast<size_t>(c_canvas_h) * c_canvas_w * kDct2;
    extract_component(cinfo, arrays, 1, c, c_canvas_h, c_canvas_w);
    extract_component(cinfo, arrays, 2, c + plane, c_canvas_h, c_canvas_w);
    extract_quant(cinfo, 1, quant + kDct2);
    extract_quant(cinfo, 2, quant + 2 * kDct2);
  } else {
    for (int i = kDct2; i < 3 * kDct2; ++i) quant[i] = 1;
  }

  jpeg_finish_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// Compress-side helpers (write_coefficients / decode_coeff / write_tensor).
// ---------------------------------------------------------------------------

// Configure component geometry for writing raw coefficients, mirroring the
// reference's fill_extended_defaults (dct_manip.cpp:211-247) but with the
// height-uses-width bug fixed (reference line 239 computed chroma
// height_in_blocks from jpeg_width).
void fill_extended_defaults(jpeg_compress_struct* cinfo, int color_samp = 2) {
#if JPEG_LIB_VERSION >= 80
  cinfo->jpeg_width = cinfo->image_width;
  cinfo->jpeg_height = cinfo->image_height;
#endif
  jpeg_set_defaults(cinfo);

  const long w = cinfo->image_width;
  const long h = cinfo->image_height;

  cinfo->comp_info[0].component_id = 1;
  cinfo->comp_info[0].h_samp_factor = 1;
  cinfo->comp_info[0].v_samp_factor = 1;
  cinfo->comp_info[0].quant_tbl_no = 0;
  cinfo->comp_info[0].width_in_blocks = div_round_up(w, kDct);
  cinfo->comp_info[0].height_in_blocks = div_round_up(h, kDct);
  cinfo->comp_info[0].MCU_width = 1;
  cinfo->comp_info[0].MCU_height = 1;

  if (cinfo->num_components > 1) {
    cinfo->comp_info[0].h_samp_factor = color_samp;
    cinfo->comp_info[0].v_samp_factor = color_samp;
    cinfo->comp_info[0].MCU_width = color_samp;
    cinfo->comp_info[0].MCU_height = color_samp;
    for (int cidx = 1; cidx < cinfo->num_components; ++cidx) {
      cinfo->comp_info[cidx].component_id = 1 + cidx;
      cinfo->comp_info[cidx].h_samp_factor = 1;
      cinfo->comp_info[cidx].v_samp_factor = 1;
      cinfo->comp_info[cidx].quant_tbl_no = 1;
      cinfo->comp_info[cidx].width_in_blocks = div_round_up(w, kDct * color_samp);
      cinfo->comp_info[cidx].height_in_blocks = div_round_up(h, kDct * color_samp);
      cinfo->comp_info[cidx].MCU_width = 1;
      cinfo->comp_info[cidx].MCU_height = 1;
    }
  }
#if JPEG_LIB_VERSION >= 70
  cinfo->min_DCT_h_scaled_size = kDct;
  cinfo->min_DCT_v_scaled_size = kDct;
#endif
}

void set_quant_tables(jpeg_compress_struct* cinfo, const int16_t* quant, int ncomp) {
  for (int t = 0; t < (ncomp > 1 ? 2 : 1); ++t) {
    if (cinfo->quant_tbl_ptrs[t] == nullptr)
      cinfo->quant_tbl_ptrs[t] = jpeg_alloc_quant_table(reinterpret_cast<j_common_ptr>(cinfo));
    for (int i = 0; i < kDct2; ++i)
      cinfo->quant_tbl_ptrs[t]->quantval[i] = static_cast<UINT16>(quant[t * kDct2 + i]);
  }
}

jvirt_barray_ptr* request_block_storage(jpeg_compress_struct* cinfo) {
  jvirt_barray_ptr* arrays = reinterpret_cast<jvirt_barray_ptr*>(
      (*cinfo->mem->alloc_small)(reinterpret_cast<j_common_ptr>(cinfo), JPOOL_IMAGE,
                                 sizeof(jvirt_barray_ptr) * cinfo->num_components));
  for (int cidx = 0; cidx < cinfo->num_components; ++cidx) {
    jpeg_component_info& comp = cinfo->comp_info[cidx];
#if JPEG_LIB_VERSION >= 80
    const long jw = cinfo->jpeg_width, jh = cinfo->jpeg_height;
#else
    const long jw = cinfo->image_width, jh = cinfo->image_height;
#endif
    int mcu_w = div_round_up(jw, comp.MCU_width);
    int mcu_h = div_round_up(jh, comp.MCU_height);
    arrays[cidx] = (*cinfo->mem->request_virt_barray)(
        reinterpret_cast<j_common_ptr>(cinfo), JPOOL_IMAGE, TRUE, mcu_w, mcu_h,
        comp.v_samp_factor);
  }
  return arrays;
}

// Write component blocks from (hb, wb, 8, 8) int16 layout.
void store_component(jpeg_compress_struct& cinfo, jvirt_barray_ptr* arrays,
                     int comp, const int16_t* src) {
  const int hb = cinfo.comp_info[comp].height_in_blocks;
  const int wb = cinfo.comp_info[comp].width_in_blocks;
  for (int row = 0; row < hb; ++row) {
    JBLOCKARRAY row_ptrs = (*cinfo.mem->access_virt_barray)(
        reinterpret_cast<j_common_ptr>(&cinfo), arrays[comp], row, 1, TRUE);
    for (int b = 0; b < wb; ++b) {
      std::memcpy(row_ptrs[0][b], src + (static_cast<size_t>(row) * wb + b) * kDct2,
                  kDct2 * sizeof(int16_t));
    }
  }
}

// Interleave planar CHW uint8 to libjpeg's H x (C*W) scanline layout.
std::vector<uint8_t> interleave_chw(const uint8_t* data, int c, int h, int w) {
  std::vector<uint8_t> out(static_cast<size_t>(h) * c * w);
  for (int ci = 0; ci < c; ++ci)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        out[static_cast<size_t>(y) * c * w + ci + static_cast<size_t>(c) * x] =
            data[(static_cast<size_t>(ci) * h + y) * w + x];
  return out;
}

// Compress coefficients (y + optional cbcr) into a JPEG, writing either to a
// file (path != null) or to a malloc'd memory buffer.
bool compress_coefficients(const char* path, unsigned char** membuf,
                           unsigned long* memsize, int image_h, int image_w,
                           bool color, const int16_t* quant, int quality,
                           const int16_t* y, const int16_t* cbcr,
                           int c_hb, int c_wb, std::string* errmsg) {
  jpeg_compress_struct cinfo{};
  ErrorMgr err{};
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  FILE* f = nullptr;
  if (setjmp(err.jump)) {
    *errmsg = err.message;
    jpeg_destroy_compress(&cinfo);
    if (f) fclose(f);
    return false;
  }
  jpeg_create_compress(&cinfo);
  if (path != nullptr) {
    f = fopen(path, "wb");
    if (!f) {
      *errmsg = std::string("Unable to open file for writing: ") + path;
      jpeg_destroy_compress(&cinfo);
      return false;
    }
    jpeg_stdio_dest(&cinfo, f);
  } else {
    jpeg_mem_dest(&cinfo, membuf, memsize);
  }

  cinfo.image_height = image_h;
  cinfo.image_width = image_w;
  cinfo.input_components = color ? 3 : 1;
  cinfo.in_color_space = color ? JCS_RGB : JCS_GRAYSCALE;
  fill_extended_defaults(&cinfo);
  if (quality > 0) {
    jpeg_set_quality(&cinfo, quality, TRUE);
  } else {
    set_quant_tables(&cinfo, quant, color ? 3 : 1);
  }

  jvirt_barray_ptr* dest = request_block_storage(&cinfo);
  jpeg_write_coefficients(&cinfo, dest);
  store_component(cinfo, dest, 0, y);
  if (color && cbcr != nullptr) {
    const size_t plane = static_cast<size_t>(c_hb) * c_wb * kDct2;
    store_component(cinfo, dest, 1, cbcr);
    store_component(cinfo, dest, 2, cbcr + plane);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  if (f) fclose(f);
  return true;
}

// Full decode of a JPEG (file or memory) to planar CHW uint8.
bool decompress_pixels(const char* path, const unsigned char* membuf,
                       unsigned long memsize, std::vector<uint8_t>* out,
                       int* c, int* h, int* w, std::string* errmsg) {
  jpeg_decompress_struct cinfo{};
  ErrorMgr err{};
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  FILE* f = nullptr;
  if (setjmp(err.jump)) {
    *errmsg = err.message;
    jpeg_destroy_decompress(&cinfo);
    if (f) fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  if (path != nullptr) {
    f = fopen(path, "rb");
    if (!f) {
      *errmsg = std::string("Unable to open file for reading: ") + path;
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_stdio_src(&cinfo, f);
  } else {
    jpeg_mem_src(&cinfo, membuf, memsize);
  }
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);
  *c = cinfo.output_components;
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  out->resize(static_cast<size_t>(*c) * *h * *w);
  std::vector<uint8_t> row(static_cast<size_t>(*w) * *c);
  JSAMPROW rowptr[1] = {row.data()};
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, rowptr, 1);
    for (int x = 0; x < *w; ++x)
      for (int ci = 0; ci < *c; ++ci)
        (*out)[(static_cast<size_t>(ci) * *h + y) * *w + x] = row[static_cast<size_t>(x) * *c + ci];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (f) fclose(f);
  return true;
}

// ===========================================================================
// Python bindings
// ===========================================================================

// --- read_coefficients(path) ------------------------------------------------
// Returns (ncomp, (dims int32 bytes), (quant int16 bytes),
//          (yh, yw, y int16 bytes), (ch, cw, c int16 bytes) | None)
PyObject* py_read_coefficients(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

  jpeg_decompress_struct cinfo{};
  ErrorMgr err{};
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;

  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_Format(PyExc_FileNotFoundError, "Unable to open file for reading: %s", path);
    return nullptr;
  }

  std::vector<int16_t> ybuf, cbuf;
  int16_t quant[3 * kDct2];
  CoeffInfo info;
  bool ok = true;
  std::string msg;

  Py_BEGIN_ALLOW_THREADS;
  if (setjmp(err.jump)) {
    ok = false;
    msg = err.message;
  } else {
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    // allocate exactly-sized outputs now that dims are known
    jpeg_decompress_struct cinfo2 = cinfo;  // header info already parsed
    (void)cinfo2;
    int yh = cinfo.comp_info[0].height_in_blocks;
    int yw = cinfo.comp_info[0].width_in_blocks;
    ybuf.resize(static_cast<size_t>(yh) * yw * kDct2);
    int chh = 0, cww = 0;
    if (cinfo.num_components > 1) {
      chh = cinfo.comp_info[1].height_in_blocks;
      cww = cinfo.comp_info[1].width_in_blocks;
      cbuf.resize(2 * static_cast<size_t>(chh) * cww * kDct2);
    }
    jvirt_barray_ptr* arrays = jpeg_read_coefficients(&cinfo);
    info.num_components = cinfo.num_components;
    for (int i = 0; i < cinfo.num_components && i < 3; ++i) {
      info.height_in_blocks[i] = cinfo.comp_info[i].height_in_blocks;
      info.width_in_blocks[i] = cinfo.comp_info[i].width_in_blocks;
      info.down_h[i] = cinfo.comp_info[i].downsampled_height;
      info.down_w[i] = cinfo.comp_info[i].downsampled_width;
    }
    extract_component(cinfo, arrays, 0, ybuf.data(), yh, yw);
    extract_quant(cinfo, 0, quant);
    if (cinfo.num_components > 1) {
      const size_t plane = static_cast<size_t>(chh) * cww * kDct2;
      extract_component(cinfo, arrays, 1, cbuf.data(), chh, cww);
      extract_component(cinfo, arrays, 2, cbuf.data() + plane, chh, cww);
      extract_quant(cinfo, 1, quant + kDct2);
      extract_quant(cinfo, 2, quant + 2 * kDct2);
    } else {
      for (int i = kDct2; i < 3 * kDct2; ++i) quant[i] = 1;
    }
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  Py_END_ALLOW_THREADS;

  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "libjpeg: %s (%s)", msg.c_str(), path);
    return nullptr;
  }

  const int nc = info.num_components;
  std::vector<int32_t> dims(static_cast<size_t>(nc) * 2);
  for (int i = 0; i < nc; ++i) {
    dims[i * 2] = info.down_h[i];
    dims[i * 2 + 1] = info.down_w[i];
  }

  PyObject* dims_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(dims.data()), dims.size() * sizeof(int32_t));
  PyObject* quant_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(quant), sizeof(quant));
  PyObject* y_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(ybuf.data()), ybuf.size() * sizeof(int16_t));
  PyObject* ret;
  if (nc > 1) {
    PyObject* c_b = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(cbuf.data()), cbuf.size() * sizeof(int16_t));
    ret = Py_BuildValue("i N N (i i N) (i i N)", nc, dims_b, quant_b,
                        info.height_in_blocks[0], info.width_in_blocks[0], y_b,
                        info.height_in_blocks[1], info.width_in_blocks[1], c_b);
  } else {
    ret = Py_BuildValue("i N N (i i N) O", nc, dims_b, quant_b,
                        info.height_in_blocks[0], info.width_in_blocks[0], y_b,
                        Py_None);
  }
  return ret;
}

// --- read_into_canvas(path, y_buf, yc_h, yc_w, c_buf, cc_h, cc_w, quant_buf)
// Hot path: decode straight into preallocated canvases (int16, C-contig).
// Zero-fills the canvases first.  Returns (ncomp, yh, yw, ch, cw, img_h, img_w).
PyObject* py_read_into_canvas(PyObject*, PyObject* args) {
  const char* path;
  Py_buffer yb, cb, qb;
  int yc_h, yc_w, cc_h, cc_w;
  if (!PyArg_ParseTuple(args, "sw*iiw*iiw*", &path, &yb, &yc_h, &yc_w, &cb,
                        &cc_h, &cc_w, &qb))
    return nullptr;

  const size_t need_y = static_cast<size_t>(yc_h) * yc_w * kDct2 * sizeof(int16_t);
  const size_t need_c = 2 * static_cast<size_t>(cc_h) * cc_w * kDct2 * sizeof(int16_t);
  if (static_cast<size_t>(yb.len) < need_y || static_cast<size_t>(cb.len) < need_c ||
      static_cast<size_t>(qb.len) < 3 * kDct2 * sizeof(int16_t)) {
    PyBuffer_Release(&yb);
    PyBuffer_Release(&cb);
    PyBuffer_Release(&qb);
    PyErr_SetString(PyExc_ValueError, "canvas buffers too small");
    return nullptr;
  }

  FILE* f = fopen(path, "rb");
  if (!f) {
    PyBuffer_Release(&yb);
    PyBuffer_Release(&cb);
    PyBuffer_Release(&qb);
    PyErr_Format(PyExc_FileNotFoundError, "Unable to open file for reading: %s", path);
    return nullptr;
  }

  jpeg_decompress_struct cinfo{};
  ErrorMgr err{};
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;

  bool ok = true;
  std::string msg;
  CoeffInfo info;
  int16_t* ydat = static_cast<int16_t*>(yb.buf);
  int16_t* cdat = static_cast<int16_t*>(cb.buf);
  int16_t* qdat = static_cast<int16_t*>(qb.buf);

  Py_BEGIN_ALLOW_THREADS;
  std::memset(ydat, 0, need_y);
  std::memset(cdat, 0, need_c);
  if (setjmp(err.jump)) {
    ok = false;
    msg = err.message;
  } else {
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    decode_coefficients(cinfo, &info, ydat, yc_h, yc_w, cdat, cc_h, cc_w, qdat);
  }
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  Py_END_ALLOW_THREADS;

  PyBuffer_Release(&yb);
  PyBuffer_Release(&cb);
  PyBuffer_Release(&qb);

  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "libjpeg: %s (%s)", msg.c_str(), path);
    return nullptr;
  }
  return Py_BuildValue("iiiiiii", info.num_components, info.height_in_blocks[0],
                       info.width_in_blocks[0], info.height_in_blocks[1],
                       info.width_in_blocks[1], info.down_h[0], info.down_w[0]);
}

// ---------------------------------------------------------------------------
// Packed (sparse top-K) decode: the transfer-compression hot path.
// Per 8x8 block we keep the K largest-|v| quantized coefficients as
// (int8 value, uint8 index) pairs plus a uint8 scale, cutting host->device
// bytes ~4x (K=16).  value = round(coeff / scale), scale = ceil(max|v|/127).
// ---------------------------------------------------------------------------
void pack_block_topk(const int16_t* block, int k, int8_t* values, uint8_t* indices,
                     uint8_t* scale_out) {
  // collect nonzeros (JPEG-quantized blocks are mostly zero)
  int idx[64];
  int n = 0;
  int16_t maxabs = 0;
  for (int i = 0; i < 64; ++i) {
    if (block[i] != 0) {
      idx[n++] = i;
      int16_t a = block[i] < 0 ? -block[i] : block[i];
      if (a > maxabs) maxabs = a;
    }
  }
  if (n > k) {
    // partial selection of the k largest |v|
    std::partial_sort(idx, idx + k, idx + n, [&](int a, int b) {
      int av = block[a] < 0 ? -block[a] : block[a];
      int bv = block[b] < 0 ? -block[b] : block[b];
      return av > bv;
    });
    n = k;
  }
  int scale = (maxabs + 126) / 127;
  if (scale < 1) scale = 1;
  if (scale > 255) scale = 255;
  *scale_out = static_cast<uint8_t>(scale);
  for (int j = 0; j < n; ++j) {
    int v = (block[idx[j]] + (block[idx[j]] >= 0 ? scale / 2 : -(scale / 2))) / scale;
    if (v > 127) v = 127;
    if (v < -127) v = -127;
    values[j] = static_cast<int8_t>(v);
    indices[j] = static_cast<uint8_t>(idx[j]);
  }
  for (int j = n; j < k; ++j) {
    values[j] = 0;
    indices[j] = 0;
  }
}

// Bitmask variant: positions of the kept coefficients live in an 8-byte
// little-endian occupancy mask (bit p of byte p/8 <=> zigzag-position p kept),
// values stored in ASCENDING POSITION order.  25 bytes/block at K=16 vs 33
// for the (value, index) pair format — same information, ~24% fewer
// host->device bytes.
void pack_block_topk_mask(const int16_t* block, int k, int8_t* values,
                          uint8_t* mask, uint8_t* scale_out) {
  int idx[64];
  int n = 0;
  int16_t maxabs = 0;
  for (int i = 0; i < 64; ++i) {
    if (block[i] != 0) {
      idx[n++] = i;
      int16_t a = block[i] < 0 ? -block[i] : block[i];
      if (a > maxabs) maxabs = a;
    }
  }
  if (n > k) {
    std::partial_sort(idx, idx + k, idx + n, [&](int a, int b) {
      int av = block[a] < 0 ? -block[a] : block[a];
      int bv = block[b] < 0 ? -block[b] : block[b];
      return av > bv;
    });
    n = k;
    std::sort(idx, idx + n);  // values must be written in position order
  }
  int scale = (maxabs + 126) / 127;
  if (scale < 1) scale = 1;
  if (scale > 255) scale = 255;
  *scale_out = static_cast<uint8_t>(scale);
  for (int j = 0; j < n; ++j) {
    int v = (block[idx[j]] + (block[idx[j]] >= 0 ? scale / 2 : -(scale / 2))) / scale;
    if (v > 127) v = 127;
    if (v < -127) v = -127;
    values[j] = static_cast<int8_t>(v);
    mask[idx[j] >> 3] |= static_cast<uint8_t>(1u << (idx[j] & 7));
  }
  for (int j = n; j < k; ++j) values[j] = 0;
}

// mask16 variant: the DC coefficient is stored EXACTLY as int16 (it is the
// largest-magnitude coefficient and would otherwise dominate the int8 scale),
// the mask/values carry only AC positions 1..63 so the AC scale is almost
// always 1 — near-lossless at K >= nonzero-AC count.  K+11 bytes/block.
void pack_block_topk_mask16(const int16_t* block, int k, int8_t* values,
                            uint8_t* mask, uint8_t* scale_out, int16_t* dc_out) {
  *dc_out = block[0];
  int idx[64];
  int n = 0;
  int16_t maxabs = 0;
  for (int i = 1; i < 64; ++i) {
    if (block[i] != 0) {
      idx[n++] = i;
      int16_t a = block[i] < 0 ? -block[i] : block[i];
      if (a > maxabs) maxabs = a;
    }
  }
  if (n > k) {
    std::partial_sort(idx, idx + k, idx + n, [&](int a, int b) {
      int av = block[a] < 0 ? -block[a] : block[a];
      int bv = block[b] < 0 ? -block[b] : block[b];
      return av > bv;
    });
    n = k;
    std::sort(idx, idx + n);
  }
  int scale = (maxabs + 126) / 127;
  if (scale < 1) scale = 1;
  if (scale > 255) scale = 255;
  *scale_out = static_cast<uint8_t>(scale);
  for (int j = 0; j < n; ++j) {
    int v = (block[idx[j]] + (block[idx[j]] >= 0 ? scale / 2 : -(scale / 2))) / scale;
    if (v > 127) v = 127;
    if (v < -127) v = -127;
    values[j] = static_cast<int8_t>(v);
    mask[idx[j] >> 3] |= static_cast<uint8_t>(1u << (idx[j] & 7));
  }
  for (int j = n; j < k; ++j) values[j] = 0;
}

// Float-input mask16 packer for host-resized (dequantized) coefficients.
// Same wire layout as pack_block_topk_mask16: exact int16 DC, int8 top-K ACs
// with a uint8 integer scale, 8-byte occupancy mask, values in ascending
// position order.  ``rows``/``stride``: block row u lives at
// ``rows + u*stride`` in the resized plane; the 8 rows are gathered into one
// contiguous local first (measured faster than strided passes).
void pack_block_topk_mask16_f32_scalar(const float* rows, long stride, int k,
                                       int8_t* values, uint8_t* mask,
                                       uint8_t* scale_out, int16_t* dc_out);

#ifdef DCTCODEC_AVX512_PACK
// Vectorized packer: one block is exactly one zmm of bytes, so the whole
// select runs on compare-mask popcounts with no histogram and no per-element
// branches.  Bit i of the occupancy mask is zigzag position i, i.e. the
// 64-bit keep mask IS the 8-byte wire mask (little-endian), and
// vpcompressb emits the kept values already in ascending position order —
// the same wire invariants the scalar path below maintains.
void pack_block_topk_mask16_f32(const float* rows, long stride, int k,
                                int8_t* values, uint8_t* mask,
                                uint8_t* scale_out, int16_t* dc_out) {
  // Gather the 8 strided rows straight into 4 zmm (2 rows each).
  auto load2 = [&](int u) {
    return _mm512_insertf32x8(
        _mm512_castps256_ps512(_mm256_loadu_ps(rows + u * stride)),
        _mm256_loadu_ps(rows + (u + 1) * stride), 1);
  };
  const __m512 f0 = load2(0), f1 = load2(2), f2 = load2(4), f3 = load2(6);

  float dc = std::nearbyint(rows[0]);
  if (dc > 32767.f) dc = 32767.f;
  if (dc < -32768.f) dc = -32768.f;
  *dc_out = static_cast<int16_t>(dc);

  // |AC| with the DC lane zeroed; max-reduce for the scale.
  const __m512 absm = _mm512_castsi512_ps(_mm512_set1_epi32(0x7fffffff));
  __m512 a0 = _mm512_maskz_and_ps(0xfffe, f0, absm);
  const __m512 a1 = _mm512_and_ps(f1, absm), a2 = _mm512_and_ps(f2, absm),
               a3 = _mm512_and_ps(f3, absm);
  const float maxabs = _mm512_reduce_max_ps(
      _mm512_max_ps(_mm512_max_ps(a0, a1), _mm512_max_ps(a2, a3)));
  int scale = static_cast<int>(std::ceil(maxabs / 127.f));
  if (scale < 1) scale = 1;
  if (scale > 255) scale = 255;
  *scale_out = static_cast<uint8_t>(scale);

  // Quantize: trunc(a*inv+0.5) == the scalar round-half-up, clamp to 127,
  // then narrow the 4 i32 vectors into ONE zmm of 64 uint8 magnitudes.
  const __m512 inv = _mm512_set1_ps(1.0f / static_cast<float>(scale));
  const __m512 half = _mm512_set1_ps(0.5f);
  const __m512i c127 = _mm512_set1_epi32(127);
  auto quant = [&](__m512 a) {
    return _mm512_min_epi32(
        _mm512_cvttps_epi32(_mm512_fmadd_ps(a, inv, half)), c127);
  };
  __m512i qb = _mm512_castsi128_si512(_mm512_cvtepi32_epi8(quant(a0)));
  qb = _mm512_inserti32x4(qb, _mm512_cvtepi32_epi8(quant(a1)), 1);
  qb = _mm512_inserti32x4(qb, _mm512_cvtepi32_epi8(quant(a2)), 2);
  qb = _mm512_inserti32x4(qb, _mm512_cvtepi32_epi8(quant(a3)), 3);

  // Signed wire bytes: negate where the source float was < 0 (strict, so
  // -0.0f stays positive exactly like the scalar `block[i] < 0.f`).
  const __m512 fz = _mm512_setzero_ps();
  const uint64_t neg =
      static_cast<uint64_t>(_mm512_cmp_ps_mask(f0, fz, _CMP_LT_OQ)) |
      (static_cast<uint64_t>(_mm512_cmp_ps_mask(f1, fz, _CMP_LT_OQ)) << 16) |
      (static_cast<uint64_t>(_mm512_cmp_ps_mask(f2, fz, _CMP_LT_OQ)) << 32) |
      (static_cast<uint64_t>(_mm512_cmp_ps_mask(f3, fz, _CMP_LT_OQ)) << 48);
  const __m512i sv =
      _mm512_mask_sub_epi8(qb, static_cast<__mmask64>(neg),
                           _mm512_setzero_si512(), qb);

  // Cut level == the scalar counting-select's: the largest L in [1,127] with
  // count(q >= L) > k (0 when even L=1 keeps <= k).  7-probe binary search
  // over compare-mask popcounts replaces the 128-bucket histogram walk.
  int lo = 1, hi = 127, level = 0;
  while (lo <= hi) {
    const int mid = (lo + hi) >> 1;
    const __mmask64 ge = _mm512_cmp_epu8_mask(
        qb, _mm512_set1_epi8(static_cast<char>(mid)), _MM_CMPINT_NLT);
    if (__builtin_popcountll(static_cast<uint64_t>(ge)) > k) {
      level = mid;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  uint64_t keep;
  if (level == 0) {  // <= k nonzero magnitudes: keep them all
    keep = static_cast<uint64_t>(
        _mm512_cmp_epu8_mask(qb, _mm512_setzero_si512(), _MM_CMPINT_NE));
  } else {
    const uint64_t gt = static_cast<uint64_t>(_mm512_cmp_epu8_mask(
        qb, _mm512_set1_epi8(static_cast<char>(level)), _MM_CMPINT_NLE));
    const uint64_t eq = static_cast<uint64_t>(_mm512_cmp_epu8_mask(
        qb, _mm512_set1_epi8(static_cast<char>(level)), _MM_CMPINT_EQ));
    const int quota = k - __builtin_popcountll(gt);  // ties that still fit
    // PDEP deposits the low `quota` set bits -> lowest positions win ties,
    // exactly the scalar's ascending-position-order quota.
    keep = gt | _pdep_u64((quota >= 64 ? ~0ull : (1ull << quota) - 1), eq);
  }
  std::memcpy(mask, &keep, 8);  // bit i of the u64 IS wire bit i (LE)
  // vpcompressb packs kept bytes to the front in position order and zeroes
  // the tail — the K-slot wire layout in one instruction.
  const __m512i comp =
      _mm512_maskz_compress_epi8(static_cast<__mmask64>(keep), sv);
  _mm512_mask_storeu_epi8(values, (k >= 64 ? ~0ull : (1ull << k) - 1), comp);
}
#else   // non-AVX512 hosts: the scalar path IS the packer
void pack_block_topk_mask16_f32(const float* rows, long stride, int k,
                                int8_t* values, uint8_t* mask,
                                uint8_t* scale_out, int16_t* dc_out) {
  pack_block_topk_mask16_f32_scalar(rows, stride, k, values, mask, scale_out,
                                    dc_out);
}
#endif  // DCTCODEC_AVX512_PACK

// Scalar packer, always compiled: the non-AVX512 production path, and the
// bit-exactness oracle the AVX-512 path is tested against (pack_debug
// binding / tests/test_ksweep.py).
void pack_block_topk_mask16_f32_scalar(const float* rows, long stride, int k,
                                       int8_t* values, uint8_t* mask,
                                       uint8_t* scale_out, int16_t* dc_out) {
  float block[kDct2];
  for (int u = 0; u < kDct; ++u)
    std::memcpy(block + u * kDct, rows + u * stride, kDct * sizeof(float));
  float dc = std::nearbyint(block[0]);
  if (dc > 32767.f) dc = 32767.f;
  if (dc < -32768.f) dc = -32768.f;
  *dc_out = static_cast<int16_t>(dc);
  // One vectorized pass: |AC| + max reduction (omp simd lets GCC vectorize
  // the float max without -ffast-math; -fopenmp-simd needs no runtime).
  float av[64];
  float maxabs = 0.f;
  av[0] = 0.f;
#pragma omp simd reduction(max : maxabs)
  for (int i = 1; i < 64; ++i) {
    const float a = std::fabs(block[i]);
    av[i] = a;
    maxabs = a > maxabs ? a : maxabs;
  }
  int scale = static_cast<int>(std::ceil(maxabs / 127.f));
  if (scale < 1) scale = 1;
  if (scale > 255) scale = 255;
  *scale_out = static_cast<uint8_t>(scale);
  // Top-K by QUANTIZED magnitude via an O(n) counting select (a sort-based
  // top-K costs ~25% of the whole crop+pack path): bucket each AC by its
  // int8 wire magnitude, walk buckets high->low to find the cut level, keep
  // everything above it plus position-order ties at the level.  Kept values
  // are written in ascending position order (the mask-format invariant).
  // The quantize pass is branch-free and auto-vectorizes; the kept value IS
  // +-qmag (same round-half-up on the magnitude the old per-element
  // lround(block/scale) computed), so the select loop does no arithmetic.
  const float inv_scale = 1.0f / static_cast<float>(scale);
  uint8_t qmag[64];
  for (int i = 1; i < 64; ++i) {
    int q = static_cast<int>(av[i] * inv_scale + 0.5f);
    qmag[i] = static_cast<uint8_t>(q > 127 ? 127 : q);
  }
  uint8_t cnt[128] = {0};  // <= 63 entries per bucket: uint8 counts suffice
  for (int i = 1; i < 64; ++i) ++cnt[qmag[i]];
  int level = 127, above = 0;
  while (level > 0 && above + cnt[level] <= k) above += cnt[level--];
  int quota = k - above;  // how many ties at `level` still fit
  int n = 0;
  for (int i = 1; i < 64 && n < k; ++i) {
    const int q = qmag[i];
    if (q == 0 || q < level) continue;
    if (q == level && quota <= 0) continue;
    if (q == level) --quota;
    values[n++] = static_cast<int8_t>(block[i] < 0.f ? -q : q);
    mask[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
  }
  for (int j = n; j < k; ++j) values[j] = 0;
}

// Wide (int16-value) variant of pack_block_topk_mask16_f32: same wire layout
// but AC values are stored as exact int16 (nearbyint of the f32 plane, scale
// fixed at 1).  Dequantized-and-clamped coefficients are integers in
// [-1024, 1016], so for identity crops this wire is BIT-EXACT; resized
// planes round to the nearest integer (max error 0.5 in dequant units vs the
// device-side dense path).  Costs K extra bytes/block over the int8 wire —
// meant for the EVAL path, where the accuracy budget matters more than
// bytes (the int8 wire's uint8 block scale reaches ~8 on high-energy blocks,
// crushing small ACs; see KSWEEP.json).
void pack_block_topk_mask16w_f32(const float* rows, long stride, int k,
                                 int16_t* values, uint8_t* mask,
                                 uint8_t* scale_out, int16_t* dc_out) {
  float block[kDct2];
  for (int u = 0; u < kDct; ++u)
    std::memcpy(block + u * kDct, rows + u * stride, kDct * sizeof(float));
  float dc = std::nearbyint(block[0]);
  if (dc > 32767.f) dc = 32767.f;
  if (dc < -32768.f) dc = -32768.f;
  *dc_out = static_cast<int16_t>(dc);
  *scale_out = 1;
  float av[64];
  av[0] = 0.f;
  int nz = 0;
#pragma omp simd reduction(+ : nz)
  for (int i = 1; i < 64; ++i) {
    const float a = std::fabs(block[i]);
    av[i] = a;
    nz += a != 0.f;
  }
  // top-K by f32 magnitude.  The common eval settings keep everything
  // (k >= nonzero count); only otherwise pay for a selection.
  float thresh = 0.f;
  int quota = k;  // ties at the threshold that still fit
  if (nz > k) {
    float srt[63];
    std::memcpy(srt, av + 1, sizeof(srt));
    std::nth_element(srt, srt + (k - 1), srt + 63, std::greater<float>());
    thresh = srt[k - 1];
    int above = 0;
    for (int i = 1; i < 64; ++i) above += av[i] > thresh;
    quota = k - above;
  }
  int n = 0;
  for (int i = 1; i < 64 && n < k; ++i) {
    const float a = av[i];
    if (a == 0.f || a < thresh) continue;
    if (a == thresh && quota <= 0) continue;
    if (a == thresh) --quota;
    float v = std::nearbyint(block[i]);
    if (v > 32767.f) v = 32767.f;
    if (v < -32768.f) v = -32768.f;
    values[n++] = static_cast<int16_t>(v);
    mask[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
  }
  for (int j = n; j < k; ++j) values[j] = 0;
}

// ---------------------------------------------------------------------------
// Host-side crop + resize + pack (the crop-before-pack transfer path).
//
// The reference crops and resizes per-sample on the CPU *before* anything
// moves to the accelerator (utils/custom_transforms.py:527-669, :819-911);
// round 1 shipped the full 64x64-block canvas and cropped on-device, paying
// ~5x more host->device bytes than needed.  This path samples the reference's
// exact crop-box distribution on the TRUE image block grid, dequantizes the
// crop window, applies the same gcd-based spectral resize the device used
// (operators passed in from ops/basis.py, exploiting their I_g (x) G
// block-diagonal structure) and packs only the target grid.
// ---------------------------------------------------------------------------

// Exact analog of the reference's choose_closest (custom_transforms.py:571-578)
// incl. torch.round's round-half-to-even via std::nearbyint.
long choose_closest(long val, const int32_t* evens, int n_evens, long maxval) {
  const long last = evens[n_evens - 1];
  if (val <= last) {
    long best = evens[0];
    long bd = std::labs(evens[0] - val);
    for (int i = 1; i < n_evens; ++i) {
      long d = std::labs(evens[i] - val);
      if (d < bd) {  // first minimum wins, like torch.argmin
        bd = d;
        best = evens[i];
      }
    }
    return best;
  }
  long m = static_cast<long>(std::nearbyint(static_cast<double>(val) / last)) * last;
  if (m > maxval) m -= last;
  return m;
}

// One resize-operator table entry (built by data/croppack.py): source size s
// resizes to the fixed target via R = I_g (x) G with G (b*8, a*8) f32.
struct OpEntry {
  int src, g, a, b;
  const float* data;  // (b*8, a*8) row-major
};

// Extract + dequantize + clamp the crop window of one component into a dense
// f32 plane laid out (h*8, w*8) with row index = block_row*8 + u.  Blocks
// outside the image grid default to zero (the reference's crop_dct zero-pads
// out-of-range coords, utils/dct_ops.py:584-599); callers whose wire
// convention is BLACK fill (the RGB pixel wire) pass oob_dc = -1024 so
// out-of-image blocks decode to black, not DC-0 mid-gray (ADVICE r3).
void extract_window_f32(jpeg_decompress_struct& cinfo, jvirt_barray_ptr* arrays,
                        int comp, const int16_t* quant, long bi, long bj,
                        long bh, long bw, float* win, float oob_dc = 0.f) {
  const long W8 = bw * kDct;
  const long hb = cinfo.comp_info[comp].height_in_blocks;
  const long wb = cinfo.comp_info[comp].width_in_blocks;
  if (bi < 0 || bj < 0 || bi + bh > hb || bj + bw > wb) {  // zero-pad case only
    std::memset(win, 0, sizeof(float) * bh * kDct * W8);
    if (oob_dc != 0.f) {
      for (long r = 0; r < bh; ++r) {
        const bool row_oob = (bi + r < 0) || (bi + r >= hb);
        for (long c = 0; c < bw; ++c)
          if (row_oob || bj + c < 0 || bj + c >= wb)
            win[(r * kDct) * W8 + c * kDct] = oob_dc;
      }
    }
  }
  float fq[kDct2];
  for (int i = 0; i < kDct2; ++i) fq[i] = static_cast<float>(quant[i]);
  for (long r = 0; r < bh; ++r) {
    const long src_r = bi + r;
    if (src_r < 0 || src_r >= hb) continue;
    JBLOCKARRAY row_ptrs = (*cinfo.mem->access_virt_barray)(
        reinterpret_cast<j_common_ptr>(&cinfo), arrays[comp],
        static_cast<JDIMENSION>(src_r), 1, FALSE);
    for (long c = 0; c < bw; ++c) {
      const long src_c = bj + c;
      if (src_c < 0 || src_c >= wb) continue;
      const int16_t* blk = reinterpret_cast<int16_t*>(row_ptrs[0][src_c]);
      for (int u = 0; u < kDct; ++u) {
        float* dst = win + (r * kDct + u) * W8 + c * kDct;
        const float* bq = fq + u * kDct;
        const int16_t* bv = blk + u * kDct;
        for (int v = 0; v < kDct; ++v) {
          float f = static_cast<float>(bv[v]) * bq[v];
          // dequant clamp, datasets.py:286-297
          f = f > 1016.f ? 1016.f : f;
          f = f < -1024.f ? -1024.f : f;
          dst[v] = f;
        }
      }
    }
  }
}

// Fused extract + row resize: tmp (t8, w8) = (I_g (x) G) @ dequant(window).
// Streams one a8-row group (L1-sized) at a time instead of materializing the
// full (h8, w8) window — saves an ~800 KB cache round trip per 56-crop.
void extract_resize_rows(jpeg_decompress_struct& cinfo, jvirt_barray_ptr* arrays,
                         int comp, const int16_t* quant, long bi, long bj,
                         long bh, long bw, const OpEntry& op, float* tmp,
                         std::vector<float>* group_scratch, float oob_dc = 0.f) {
  const long w8 = bw * kDct;
  const int a8 = op.a * kDct, b8 = op.b * kDct;
  group_scratch->resize(static_cast<size_t>(a8) * w8);
  float* grp = group_scratch->data();
  const long hb = cinfo.comp_info[comp].height_in_blocks;
  const long wb = cinfo.comp_info[comp].width_in_blocks;
  float fq[kDct2];
  for (int i = 0; i < kDct2; ++i) fq[i] = static_cast<float>(quant[i]);
  for (int m = 0; m < op.g; ++m) {
    // extract + dequant + clamp this group's a rows of blocks
    for (int ar = 0; ar < op.a; ++ar) {
      const long r = static_cast<long>(m) * op.a + ar;
      const long src_r = bi + r;
      float* rows = grp + static_cast<size_t>(ar) * kDct * w8;
      if (src_r < 0 || src_r >= hb) {
        std::memset(rows, 0, sizeof(float) * kDct * w8);
        if (oob_dc != 0.f)
          for (long c = 0; c < bw; ++c) rows[c * kDct] = oob_dc;
        continue;
      }
      JBLOCKARRAY row_ptrs = (*cinfo.mem->access_virt_barray)(
          reinterpret_cast<j_common_ptr>(&cinfo), arrays[comp],
          static_cast<JDIMENSION>(src_r), 1, FALSE);
      for (long c = 0; c < bw; ++c) {
        const long src_c = bj + c;
        if (src_c < 0 || src_c >= wb) {
          for (int u = 0; u < kDct; ++u)
            std::memset(rows + static_cast<size_t>(u) * w8 + c * kDct, 0,
                        kDct * sizeof(float));
          if (oob_dc != 0.f) rows[c * kDct] = oob_dc;
          continue;
        }
        const int16_t* blk = reinterpret_cast<int16_t*>(row_ptrs[0][src_c]);
        for (int u = 0; u < kDct; ++u) {
          float* dst = rows + static_cast<size_t>(u) * w8 + c * kDct;
          const float* bq = fq + u * kDct;
          const int16_t* bv = blk + u * kDct;
          for (int v = 0; v < kDct; ++v) {
            float f = static_cast<float>(bv[v]) * bq[v];
            f = f > 1016.f ? 1016.f : f;
            f = f < -1024.f ? -1024.f : f;
            dst[v] = f;
          }
        }
      }
    }
    // multiply while hot: tmp group rows = G @ grp
    float* tmp_g = tmp + static_cast<size_t>(m) * b8 * w8;
    for (int r = 0; r < b8; ++r) {
      const float* grow = op.data + static_cast<size_t>(r) * a8;
      float* outr = tmp_g + static_cast<size_t>(r) * w8;
      std::memset(outr, 0, sizeof(float) * w8);
      for (int q = 0; q < a8; ++q) {
        const float gq = grow[q];
        if (gq == 0.f) continue;
        const float* src = grp + static_cast<size_t>(q) * w8;
        for (long x = 0; x < w8; ++x) outr[x] += gq * src[x];
      }
    }
  }
}

// tmp (t8, w8) = (I_g (x) G) @ win (h8, w8);   G is (b8, a8), h = g*a, t = g*b.
void apply_rows(const OpEntry& op, const float* win, long w8, float* tmp) {
  const int a8 = op.a * kDct, b8 = op.b * kDct;
  for (int m = 0; m < op.g; ++m) {
    const float* win_g = win + static_cast<size_t>(m) * a8 * w8;
    float* tmp_g = tmp + static_cast<size_t>(m) * b8 * w8;
    for (int r = 0; r < b8; ++r) {
      const float* grow = op.data + static_cast<size_t>(r) * a8;
      float* out = tmp_g + static_cast<size_t>(r) * w8;
      std::memset(out, 0, sizeof(float) * w8);
      for (int q = 0; q < a8; ++q) {
        const float gq = grow[q];
        if (gq == 0.f) continue;
        const float* src = win_g + static_cast<size_t>(q) * w8;
        for (long x = 0; x < w8; ++x) out[x] += gq * src[x];
      }
    }
  }
}

// out (t8, tw8) = tmp (t8, w8) @ (I_g (x) G)^T along columns.  Uses a
// transposed copy of G so the inner loop runs contiguously over output
// columns (vectorizes; the dot-product form had 8/16-long reductions).
void apply_cols(const OpEntry& op, const float* tmp, long t8_rows, float* out,
                std::vector<float>* gt_scratch) {
  const int a8 = op.a * kDct, b8 = op.b * kDct;
  const long w8 = static_cast<long>(op.g) * a8;
  const long tw8 = static_cast<long>(op.g) * b8;
  gt_scratch->resize(static_cast<size_t>(a8) * b8);
  float* gt = gt_scratch->data();
  for (int p = 0; p < b8; ++p)
    for (int q = 0; q < a8; ++q) gt[static_cast<size_t>(q) * b8 + p] = op.data[static_cast<size_t>(p) * a8 + q];
  for (long y = 0; y < t8_rows; ++y) {
    const float* trow = tmp + y * w8;
    float* orow = out + y * tw8;
    std::memset(orow, 0, sizeof(float) * tw8);
    for (int m = 0; m < op.g; ++m) {
      const float* tg = trow + static_cast<size_t>(m) * a8;
      float* og = orow + static_cast<size_t>(m) * b8;
      for (int q = 0; q < a8; ++q) {
        const float tq = tg[q];
        if (tq == 0.f) continue;
        const float* gq = gt + static_cast<size_t>(q) * b8;
        for (int p = 0; p < b8; ++p) og[p] += tq * gq[p];
      }
    }
  }
}

// Requantize a resized (t*8, t*8) dequantized f32 plane back to JPEG
// integer units: v -> round(v / q[u, v]) per coefficient position.  This is
// the "mask16q" wire's denoise/selection domain — the SAME domain the full-
// canvas packed wire ranks in (libjpeg's stored quantized coefficients), so
// top-K keeps the perceptually significant coefficients and sub-half-quant
// resize residue rounds away.  The device multiplies the quant table back
// (augment.pipeline.dequantize), exactly like the packed path.
void requant_plane(float* plane, int t, const int16_t* q) {
  const long t8 = static_cast<long>(t) * kDct;
  for (long r = 0; r < t8; ++r) {
    float* row = plane + r * t8;
    const int16_t* qrow = q + (r & 7) * kDct;
    for (long c = 0; c < t8; ++c)
      row[c] = std::nearbyint(row[c] / static_cast<float>(qrow[c & 7]));
  }
}

// Pack a resized (t*8, t*8) f32 plane into mask16 wire fields on a t x t
// grid.  `wide` selects the int16-value wire (`values` is then int16 bytes).
void pack_plane_mask16(const float* plane, int t, int k, int8_t* values,
                       uint8_t* mask, uint8_t* scales, int16_t* dcs,
                       bool wide = false) {
  const long T8 = static_cast<long>(t) * kDct;
  for (int r = 0; r < t; ++r) {
    for (int c = 0; c < t; ++c) {
      const size_t off = static_cast<size_t>(r) * t + c;
      const float* blk =
          plane + static_cast<long>(r) * kDct * T8 + static_cast<long>(c) * kDct;
      if (wide)
        pack_block_topk_mask16w_f32(
            blk, T8, k, reinterpret_cast<int16_t*>(values) + off * k,
            mask + off * 8, scales + off, dcs + off);
      else
        pack_block_topk_mask16_f32(blk, T8, k, values + off * k, mask + off * 8,
                                   scales + off, dcs + off);
    }
  }
}

enum CropMode { kCropRandom = 0, kCropCenter = 1, kCropFull = 2 };

// The box-sampling logic.  mode 0: reference RandomResizedCrop_DCT.get_params
// with ratio fixed 1:1 (custom_transforms.py:557-629) driven by caller
// uniforms (10 area draws + 2 offset draws); mode 1: ResizedCenterCrop_DCT
// (custom_transforms.py:850-884); mode 2: whole-image resize (swin val,
// datasets.py:381).  All sizes land in [1, max_src]; offsets are floored to
// chroma multiples.
void sample_box(CropMode mode, long height, long width, const double* u,
                double scale_lo, double scale_hi, double ratio,
                const int32_t* evens, int n_evens, long* bi, long* bj, long* bh,
                long* bw) {
  if (mode == kCropFull) {
    *bi = 0; *bj = 0; *bh = height; *bw = width;
    return;
  }
  if (mode == kCropCenter) {
    long w = choose_closest(std::lround(std::nearbyint(ratio * width)), evens, n_evens, width);
    long h = choose_closest(std::lround(std::nearbyint(ratio * height)), evens, n_evens, height);
    // floor-div (python //) handles negative values for tiny images
    auto fdiv = [](long a, long b) { return a >= 0 ? a / b : -((-a + b - 1) / b); };
    *bi = fdiv(fdiv(height - h, 2), 2) * 2;
    *bj = fdiv(fdiv(width - w, 2), 2) * 2;
    *bh = std::max(1L, h);
    *bw = std::max(1L, w);
    return;
  }
  const double area = static_cast<double>(height) * width;
  for (int t = 0; t < 10; ++t) {
    const double target_area = area * (scale_lo + u[t] * (scale_hi - scale_lo));
    long w = std::lround(std::nearbyint(std::sqrt(target_area)));
    w = choose_closest(w, evens, n_evens, width);
    long h = w;  // ratio fixed 1:1 (datasets.py:357, :373)
    w = std::max(2L, w);
    h = std::max(2L, h);
    if (w <= width && h <= height) {
      long i = static_cast<long>(u[10] * (height - h + 1));
      if (i > height - h) i = height - h;
      long j = static_cast<long>(u[11] * (width - w + 1));
      if (j > width - w) j = width - w;
      *bi = i / 2 * 2;
      *bj = j / 2 * 2;
      *bh = std::max(1L, h);
      *bw = std::max(1L, w);
      return;
    }
  }
  // fallback: central crop.  With ratio fixed 1:1 the reference sets both
  // sides to min(width, height) before snapping each against its own maxval
  // (custom_transforms.py:615-627).
  const long md = std::min(width, height);
  long w = choose_closest(md, evens, n_evens, width);
  long h = choose_closest(md, evens, n_evens, height);
  auto fdiv = [](long a, long b) { return a >= 0 ? a / b : -((-a + b - 1) / b); };
  *bi = fdiv(fdiv(height - h, 2), 2) * 2;
  *bj = fdiv(fdiv(width - w, 2), 2) * 2;
  *bh = std::max(1L, h);
  *bw = std::max(1L, w);
}

enum PackFmt { kPackIndex = 0, kPackMask = 1, kPackMask16 = 2 };

void pack_component(jpeg_decompress_struct& cinfo, jvirt_barray_ptr* arrays, int comp,
                    int k, int canvas_h, int canvas_w, int8_t* values,
                    uint8_t* indices, uint8_t* scales, PackFmt fmt,
                    int16_t* dcs = nullptr) {
  const int hb = std::min<int>(cinfo.comp_info[comp].height_in_blocks, canvas_h);
  const int wb = std::min<int>(cinfo.comp_info[comp].width_in_blocks, canvas_w);
  const size_t istride = fmt == kPackIndex ? static_cast<size_t>(k) : 8;
  for (int row = 0; row < hb; ++row) {
    JBLOCKARRAY row_ptrs = (*cinfo.mem->access_virt_barray)(
        reinterpret_cast<j_common_ptr>(&cinfo), arrays[comp], row, 1, FALSE);
    for (int b = 0; b < wb; ++b) {
      size_t off = (static_cast<size_t>(row) * canvas_w + b);
      const int16_t* blk = reinterpret_cast<int16_t*>(row_ptrs[0][b]);
      if (fmt == kPackMask16)
        pack_block_topk_mask16(blk, k, values + off * k, indices + off * istride,
                               scales + off, dcs + off);
      else if (fmt == kPackMask)
        pack_block_topk_mask(blk, k, values + off * k, indices + off * istride,
                             scales + off);
      else
        pack_block_topk(blk, k, values + off * k, indices + off * istride,
                        scales + off);
    }
  }
}

// --- read_into_packed(path, k, vy, iy, sy, yc_h, yc_w, vc, ic, sc, cc_h,
//                      cc_w, quant_buf) -> (ncomp, yh, yw, ch, cw) -----------
// kPackMask: iy/ic hold 8-byte occupancy bitmasks instead of K uint8 indices.
// kPackMask16 additionally parses dy/dcc int16 DC buffers (after sy / sc).
PyObject* read_into_packed_impl(PyObject* args, PackFmt fmt) {
  const char* path;
  int k, yc_h, yc_w, cc_h, cc_w;
  Py_buffer vy, iy, sy, vc, ic, sc, qb;
  Py_buffer dy{}, dcc{};
  if (fmt == kPackMask16) {
    if (!PyArg_ParseTuple(args, "siw*w*w*w*iiw*w*w*w*iiw*", &path, &k, &vy, &iy,
                          &sy, &dy, &yc_h, &yc_w, &vc, &ic, &sc, &dcc, &cc_h,
                          &cc_w, &qb))
      return nullptr;
  } else {
    if (!PyArg_ParseTuple(args, "siw*w*w*iiw*w*w*iiw*", &path, &k, &vy, &iy, &sy,
                          &yc_h, &yc_w, &vc, &ic, &sc, &cc_h, &cc_w, &qb))
      return nullptr;
  }

  const bool has_dc = fmt == kPackMask16;
  const size_t y_blocks = static_cast<size_t>(yc_h) * yc_w;
  const size_t c_blocks = 2 * static_cast<size_t>(cc_h) * cc_w;
  const size_t istride = fmt == kPackIndex ? static_cast<size_t>(k) : 8;
  std::vector<Py_buffer*> bufs = {&vy, &iy, &sy, &vc, &ic, &sc, &qb};
  std::vector<size_t> needs = {y_blocks * k, y_blocks * istride, y_blocks,
                               c_blocks * k, c_blocks * istride, c_blocks,
                               3 * kDct2 * sizeof(int16_t)};
  if (has_dc) {
    bufs.push_back(&dy);
    needs.push_back(y_blocks * sizeof(int16_t));
    bufs.push_back(&dcc);
    needs.push_back(c_blocks * sizeof(int16_t));
  }
  for (size_t i = 0; i < bufs.size(); ++i) {
    if (static_cast<size_t>(bufs[i]->len) < needs[i]) {
      for (auto* b : bufs) PyBuffer_Release(b);
      PyErr_SetString(PyExc_ValueError, "packed canvas buffer too small");
      return nullptr;
    }
  }

  FILE* f = fopen(path, "rb");
  if (!f) {
    for (auto* b : bufs) PyBuffer_Release(b);
    PyErr_Format(PyExc_FileNotFoundError, "Unable to open file for reading: %s", path);
    return nullptr;
  }

  jpeg_decompress_struct cinfo{};
  ErrorMgr err{};
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;

  bool ok = true;
  std::string msg;
  CoeffInfo info;

  Py_BEGIN_ALLOW_THREADS;
  std::memset(vy.buf, 0, needs[0]);
  std::memset(iy.buf, 0, needs[1]);
  std::memset(sy.buf, 1, needs[2]);  // scale 1 for empty blocks
  std::memset(vc.buf, 0, needs[3]);
  std::memset(ic.buf, 0, needs[4]);
  std::memset(sc.buf, 1, needs[5]);
  if (has_dc) {
    // Canvas area beyond the image decodes to BLACK (Y DC = -1024 -> sample
    // 0; chroma DC = 0 -> neutral 128), matching the dense RGB loader's
    // zero-filled pixel canvases.  In-image blocks overwrite below.
    int16_t* dyp = static_cast<int16_t*>(dy.buf);
    for (size_t i = 0; i < y_blocks; ++i) dyp[i] = -1024;
    std::memset(dcc.buf, 0, needs[8]);
  }
  if (setjmp(err.jump)) {
    ok = false;
    msg = err.message;
  } else {
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    jvirt_barray_ptr* arrays = jpeg_read_coefficients(&cinfo);
    info.num_components = cinfo.num_components;
    for (int i = 0; i < cinfo.num_components && i < 3; ++i) {
      info.height_in_blocks[i] = cinfo.comp_info[i].height_in_blocks;
      info.width_in_blocks[i] = cinfo.comp_info[i].width_in_blocks;
    }
    int16_t* qdat = static_cast<int16_t*>(qb.buf);
    pack_component(cinfo, arrays, 0, k, yc_h, yc_w, static_cast<int8_t*>(vy.buf),
                   static_cast<uint8_t*>(iy.buf), static_cast<uint8_t*>(sy.buf),
                   fmt, has_dc ? static_cast<int16_t*>(dy.buf) : nullptr);
    extract_quant(cinfo, 0, qdat);
    if (cinfo.num_components > 1) {
      const size_t plane = static_cast<size_t>(cc_h) * cc_w;
      pack_component(cinfo, arrays, 1, k, cc_h, cc_w, static_cast<int8_t*>(vc.buf),
                     static_cast<uint8_t*>(ic.buf), static_cast<uint8_t*>(sc.buf),
                     fmt, has_dc ? static_cast<int16_t*>(dcc.buf) : nullptr);
      pack_component(cinfo, arrays, 2, k, cc_h, cc_w,
                     static_cast<int8_t*>(vc.buf) + plane * k,
                     static_cast<uint8_t*>(ic.buf) + plane * istride,
                     static_cast<uint8_t*>(sc.buf) + plane, fmt,
                     has_dc ? static_cast<int16_t*>(dcc.buf) + plane : nullptr);
      extract_quant(cinfo, 1, qdat + kDct2);
      extract_quant(cinfo, 2, qdat + 2 * kDct2);
    } else {
      for (int i = kDct2; i < 3 * kDct2; ++i) qdat[i] = 1;
    }
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  Py_END_ALLOW_THREADS;

  for (auto* b : bufs) PyBuffer_Release(b);
  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "libjpeg: %s (%s)", msg.c_str(), path);
    return nullptr;
  }
  return Py_BuildValue("iiiii", info.num_components, info.height_in_blocks[0],
                       info.width_in_blocks[0], info.height_in_blocks[1],
                       info.width_in_blocks[1]);
}

// ---------------------------------------------------------------------------
// Crop-before-pack core (GIL-free; wrappers below handle Python buffers).
// Huffman decode, sample the crop box on the true image block grid,
// dequantize + clamp the window, resize it to the (t_y, t_c) target grids
// with the caller's gcd group operators, mask16-pack only the target blocks.
// ---------------------------------------------------------------------------
struct CropPackPtrs {
  int8_t* vy;
  uint8_t* my;
  uint8_t* sy;
  int16_t* dy;
  int8_t* vc;
  uint8_t* mc;
  uint8_t* sc;
  int16_t* dc;
  int16_t* quant;
};

bool crop_pack_core(const char* path, int k, CropMode mode, int t_y, int t_c,
                    int max_src, const double* uniforms, double scale_lo,
                    double scale_hi, double ratio, const int32_t* evens,
                    int n_evens, const int32_t* spec, size_t n_spec,
                    const float* opdata, size_t n_opdata, const CropPackPtrs& o,
                    CoeffInfo* info, long box[4], std::string* msg,
                    bool wide = false, bool requant = false) {
  const size_t yblk = static_cast<size_t>(t_y) * t_y;
  const size_t cblk = 2 * static_cast<size_t>(t_c) * t_c;
  const size_t vsz = wide ? 2 : 1;  // value bytes (int16 wide / int8)

  auto get_ops = [&](long src, OpEntry* oy, OpEntry* oc) {
    if (src < 1 || static_cast<size_t>(src) > n_spec) {
      *msg = "crop size outside operator table";
      return false;
    }
    const int32_t* row = spec + (src - 1) * 10;
    if (row[0] != src) {
      *msg = "operator table not indexed by size";
      return false;
    }
    *oy = OpEntry{static_cast<int>(src), row[1], row[2], row[3], opdata + row[4]};
    *oc = OpEntry{row[5], row[6], row[7], row[8], opdata + row[9]};
    if (oy->g * oy->a != src || oy->g * oy->b != t_y ||
        oc->g * oc->a != oc->src || oc->g * oc->b != t_c ||
        static_cast<size_t>(row[4]) + static_cast<size_t>(oy->b) * kDct * oy->a * kDct > n_opdata ||
        static_cast<size_t>(row[9]) + static_cast<size_t>(oc->b) * kDct * oc->a * kDct > n_opdata) {
      *msg = "inconsistent operator table entry";
      return false;
    }
    return true;
  };

  FILE* f = fopen(path, "rb");
  if (!f) {
    *msg = std::string("Unable to open file for reading: ") + path;
    return false;
  }

  jpeg_decompress_struct cinfo{};
  ErrorMgr err{};
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;

  bool ok = true;
  std::memset(o.vy, 0, yblk * k * vsz);
  std::memset(o.my, 0, yblk * 8);
  std::memset(o.sy, 1, yblk);
  std::memset(o.dy, 0, yblk * sizeof(int16_t));
  std::memset(o.vc, 0, cblk * k * vsz);
  std::memset(o.mc, 0, cblk * 8);
  std::memset(o.sc, 1, cblk);
  std::memset(o.dc, 0, cblk * sizeof(int16_t));  // neutral chroma (gray)
  if (setjmp(err.jump)) {
    ok = false;
    *msg = err.message;
  } else {
    const bool prof = g_prof_enabled.load(std::memory_order_relaxed);
    uint64_t t0 = prof ? prof_now() : 0;
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    jvirt_barray_ptr* arrays = jpeg_read_coefficients(&cinfo);
    if (prof) {
      uint64_t t1 = prof_now();
      g_prof.decode.fetch_add(t1 - t0, std::memory_order_relaxed);
      g_prof.n.fetch_add(1, std::memory_order_relaxed);
    }
    info->num_components = cinfo.num_components;
    for (int i = 0; i < cinfo.num_components && i < 3; ++i) {
      info->height_in_blocks[i] = cinfo.comp_info[i].height_in_blocks;
      info->width_in_blocks[i] = cinfo.comp_info[i].width_in_blocks;
    }
    extract_quant(cinfo, 0, o.quant);
    if (cinfo.num_components > 1) {
      extract_quant(cinfo, 1, o.quant + kDct2);
      extract_quant(cinfo, 2, o.quant + 2 * kDct2);
    } else {
      for (int i = kDct2; i < 3 * kDct2; ++i) o.quant[i] = 1;
    }

    // sample the crop box on the true (clamped) block grid
    const long height = std::min<long>(info->height_in_blocks[0], max_src);
    const long width = std::min<long>(info->width_in_blocks[0], max_src);
    long bi, bj, bh, bw;
    sample_box(mode, height, width, uniforms, scale_lo, scale_hi, ratio,
               evens, n_evens, &bi, &bj, &bh, &bw);
    box[0] = bi; box[1] = bj; box[2] = bh; box[3] = bw;

    OpEntry oyh, och, oyw, ocw;
    if (!get_ops(bh, &oyh, &och) || !get_ops(bw, &oyw, &ocw)) {
      ok = false;
    } else {
      // persistent per-thread scratch: fresh MB-sized vectors each call cost
      // more in page faults + double zeroing than the resize math itself
      thread_local std::vector<float> win, tmp, out, gt, grp;
      const long t8 = static_cast<long>(t_y) * kDct;
      const bool prof = g_prof_enabled.load(std::memory_order_relaxed);
      uint64_t te0 = prof ? prof_now() : 0;
      const float* plane;
      if (bh == t_y && bw == t_y) {  // identity crop: extract + pack only
        win.resize(static_cast<size_t>(bh) * kDct * bw * kDct);
        extract_window_f32(cinfo, arrays, 0, o.quant, bi, bj, bh, bw, win.data());
        plane = win.data();
      } else {
        tmp.resize(static_cast<size_t>(t8) * bw * kDct);
        out.resize(static_cast<size_t>(t8) * t8);
        extract_resize_rows(cinfo, arrays, 0, o.quant, bi, bj, bh, bw, oyh,
                            tmp.data(), &grp);
        apply_cols(oyw, tmp.data(), t8, out.data(), &gt);
        plane = out.data();
      }
      uint64_t tp0 = 0;
      if (prof) {
        tp0 = prof_now();
        g_prof.extract_resize.fetch_add(tp0 - te0, std::memory_order_relaxed);
      }
      if (requant)  // plane aliases the mutable win/out scratch
        requant_plane(const_cast<float*>(plane), t_y, o.quant);
      pack_plane_mask16(plane, t_y, k, o.vy, o.my, o.sy, o.dy, wide);
      if (prof)
        g_prof.pack.fetch_add(prof_now() - tp0, std::memory_order_relaxed);

      if (cinfo.num_components > 1) {
        // chroma box: offsets halved (multiples of 2 -> exact), sizes from
        // the operator table (h//2 for crops, ceil for full-image resize)
        const long tc8 = static_cast<long>(t_c) * kDct;
        const long csh = och.src, csw = ocw.src;
        thread_local std::vector<float> cwin, ctmp, cout;
        const bool cident = csh == t_c && csw == t_c;
        if (cident) {
          cwin.resize(static_cast<size_t>(csh) * kDct * csw * kDct);
        } else {
          ctmp.resize(static_cast<size_t>(tc8) * csw * kDct);
          cout.resize(static_cast<size_t>(tc8) * tc8);
        }
        for (int comp = 1; comp < 3; ++comp) {
          uint64_t ce0 = prof ? prof_now() : 0;
          const float* cplane;
          if (cident) {
            extract_window_f32(cinfo, arrays, comp, o.quant + comp * kDct2,
                               bi / 2, bj / 2, csh, csw, cwin.data());
            cplane = cwin.data();
          } else {
            extract_resize_rows(cinfo, arrays, comp, o.quant + comp * kDct2,
                                bi / 2, bj / 2, csh, csw, och, ctmp.data(), &grp);
            apply_cols(ocw, ctmp.data(), tc8, cout.data(), &gt);
            cplane = cout.data();
          }
          uint64_t cp0 = 0;
          if (prof) {
            cp0 = prof_now();
            g_prof.extract_resize.fetch_add(cp0 - ce0, std::memory_order_relaxed);
          }
          const size_t plane_n = static_cast<size_t>(t_c) * t_c;
          const size_t po = (comp - 1) * plane_n;
          if (requant)
            requant_plane(const_cast<float*>(cplane), t_c, o.quant + comp * kDct2);
          pack_plane_mask16(cplane, t_c, k, o.vc + po * k * vsz, o.mc + po * 8,
                            o.sc + po, o.dc + po, wide);
          if (prof)
            g_prof.pack.fetch_add(prof_now() - cp0, std::memory_order_relaxed);
        }
      }
      jpeg_finish_decompress(&cinfo);
    }
  }
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// RGB crop-before-pack: host-sample the reference's PIXEL-granular RGB crop
// box (torchvision RandomResizedCrop semantics, datasets.py:320 — unlike the
// DCT path's block-snapped boxes), ship only the block-aligned window that
// covers it, spectrally pre-downsampled by a per-axis factor f in {1,2,4} so
// it always fits a fixed t-block wire, and let the device JPEG-tail-decode
// the window and bilinear-resample the residual fractional box.
// ---------------------------------------------------------------------------

enum RgbCropMode { kRgbTrain = 0, kRgbCenter = 1, kRgbFull = 2 };

// torchvision RandomResizedCrop.get_params: 10 tries of (area, log-aspect)
// draws + one (i, j) placement, center-crop fallback.  uniforms: 10x2 + 2.
void sample_rrc_pixel_box(long H, long W, const double* u, double s0,
                          double s1, long* bi, long* bj, long* bh, long* bw) {
  const double area = static_cast<double>(H) * W;
  const double lr0 = std::log(3.0 / 4.0), lr1 = std::log(4.0 / 3.0);
  for (int t = 0; t < 10; ++t) {
    const double target_area = area * (s0 + u[2 * t] * (s1 - s0));
    const double aspect = std::exp(lr0 + u[2 * t + 1] * (lr1 - lr0));
    long w = std::lround(std::sqrt(target_area * aspect));
    long h = std::lround(std::sqrt(target_area / aspect));
    if (0 < w && w <= W && 0 < h && h <= H) {
      long i = static_cast<long>(u[20] * (H - h + 1));
      if (i > H - h) i = H - h;
      long j = static_cast<long>(u[21] * (W - w + 1));
      if (j > W - w) j = W - w;
      *bi = i; *bj = j; *bh = h; *bw = w;
      return;
    }
  }
  const double in_ratio = static_cast<double>(W) / H;
  long w, h;
  if (in_ratio < 3.0 / 4.0) {
    w = W;
    h = std::lround(w / (3.0 / 4.0));
  } else if (in_ratio > 4.0 / 3.0) {
    h = H;
    w = std::lround(h * (4.0 / 3.0));
  } else {
    w = W;
    h = H;
  }
  *bi = (H - h) / 2; *bj = (W - w) / 2; *bh = h; *bw = w;
}

// One axis: pick the 16px-aligned block window [w0, w0+wb) covering pixel
// span [p0, p0+len) and the smallest factor f in {1,2,4} with wb/f <= t.
// wb must be a multiple of 2f so the halved CHROMA window (wb/2 blocks)
// divides by f too.  Returns false if even f=4 cannot fit (axis > 32*t px).
bool window_axis(double p0, double len, long t, long* w0, long* wb, int* f) {
  long b0 = static_cast<long>(std::floor(p0 / 16.0)) * 2;
  if (b0 < 0) b0 = 0;
  long b1 = static_cast<long>(std::ceil((p0 + len) / 16.0)) * 2;
  if (b1 <= b0) b1 = b0 + 2;
  long n = b1 - b0;  // even by construction
  int fac;
  if (n <= t) {
    fac = 1;
  } else if ((n + 3) / 4 * 4 <= 2 * t) {
    fac = 2;
    n = (n + 3) / 4 * 4;
  } else {
    n = (n + 7) / 8 * 8;
    if (n > 4 * t) return false;
    fac = 4;
  }
  *w0 = b0;
  *wb = n;
  *f = fac;
  return true;
}

// Rectangular mask16 pack: (th, tw) resized blocks into the top-left of a
// (grid, grid) wire; the rest of the wire keeps its zero fill.
void pack_plane_rect_mask16(const float* plane, int th, int tw, int grid,
                            int k, int8_t* values, uint8_t* mask,
                            uint8_t* scales, int16_t* dcs) {
  const long W8 = static_cast<long>(tw) * kDct;
  for (int r = 0; r < th; ++r) {
    for (int c = 0; c < tw; ++c) {
      const size_t off = static_cast<size_t>(r) * grid + c;
      pack_block_topk_mask16_f32(
          plane + static_cast<long>(r) * kDct * W8 + static_cast<long>(c) * kDct,
          W8, k, values + off * k, mask + off * 8, scales + off, dcs + off);
    }
  }
}

// Extract one component's window and apply the per-axis {1,2,4} spectral
// downsample.  g2/g4: the (8, f*8) group blocks of resize_axis_operator(f,1).
// Writes the resized (bh/fy*8, bw/fx*8) plane pointer into *plane.
void extract_downsample(jpeg_decompress_struct& cinfo, jvirt_barray_ptr* arrays,
                        int comp, const int16_t* quant, long bi, long bj,
                        long bh, long bw, int fy, int fx, const float* g2,
                        const float* g4, std::vector<float>* win,
                        std::vector<float>* tmp, std::vector<float>* out,
                        std::vector<float>* gt, std::vector<float>* grp,
                        const float** plane, float oob_dc = 0.f) {
  const long oh8 = bh / fy * kDct, ow8 = bw / fx * kDct;
  if (fy == 1 && fx == 1) {
    win->resize(static_cast<size_t>(bh) * kDct * bw * kDct);
    extract_window_f32(cinfo, arrays, comp, quant, bi, bj, bh, bw, win->data(),
                       oob_dc);
    *plane = win->data();
    return;
  }
  OpEntry oy{static_cast<int>(bh), static_cast<int>(bh / fy), fy, 1,
             fy == 2 ? g2 : g4};
  OpEntry ox{static_cast<int>(bw), static_cast<int>(bw / fx), fx, 1,
             fx == 2 ? g2 : g4};
  if (fy == 1) {
    win->resize(static_cast<size_t>(bh) * kDct * bw * kDct);
    extract_window_f32(cinfo, arrays, comp, quant, bi, bj, bh, bw, win->data(),
                       oob_dc);
    out->resize(static_cast<size_t>(oh8) * ow8);
    apply_cols(ox, win->data(), oh8, out->data(), gt);
    *plane = out->data();
    return;
  }
  tmp->resize(static_cast<size_t>(oh8) * bw * kDct);
  extract_resize_rows(cinfo, arrays, comp, quant, bi, bj, bh, bw, oy,
                      tmp->data(), grp, oob_dc);
  if (fx == 1) {
    *plane = tmp->data();
    return;
  }
  out->resize(static_cast<size_t>(oh8) * ow8);
  apply_cols(ox, tmp->data(), oh8, out->data(), gt);
  *plane = out->data();
}

// Core: decode -> pixel box -> per-axis window+factor -> extract+downsample
// -> rect mask16 pack (t-block luma, t/2-block chroma) + residual-resample
// geometry in window pixels.  geom: [sy0, sh, sx0, sw] f32.
bool rgb_crop_pack_core(const char* path, int k, int t, RgbCropMode mode,
                        const double* uniforms, double scale_lo, double scale_hi,
                        double resize_to, double crop, const float* g2,
                        const float* g4, CropPackPtrs o, CoeffInfo* info,
                        long* win_out, float* geom, std::string* msg) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    *msg = "unable to open file";
    return false;
  }
  jpeg_decompress_struct cinfo{};
  ErrorMgr err{};
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;

  const int t_c = t / 2;
  const size_t yblk = static_cast<size_t>(t) * t;
  const size_t cblk = 2 * static_cast<size_t>(t_c) * t_c;
  bool ok = true;
  std::memset(o.vy, 0, yblk * k);
  std::memset(o.my, 0, yblk * 8);
  std::memset(o.sy, 1, yblk);
  std::memset(o.vc, 0, cblk * k);
  std::memset(o.mc, 0, cblk * 8);
  std::memset(o.sc, 1, cblk);
  std::memset(o.dc, 0, cblk * sizeof(int16_t));  // neutral chroma
  // out-of-window area decodes to BLACK: Y DC -1024 (dequantized wire)
  for (size_t i = 0; i < yblk; ++i) o.dy[i] = -1024;

  if (setjmp(err.jump)) {
    ok = false;
    *msg = err.message;
  } else {
    const bool prof = g_prof_enabled.load(std::memory_order_relaxed);
    uint64_t t0 = prof ? prof_now() : 0;
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    jvirt_barray_ptr* arrays = jpeg_read_coefficients(&cinfo);
    if (prof) {
      g_prof.decode.fetch_add(prof_now() - t0, std::memory_order_relaxed);
      g_prof.n.fetch_add(1, std::memory_order_relaxed);
    }
    info->num_components = cinfo.num_components;
    for (int i = 0; i < cinfo.num_components && i < 3; ++i) {
      info->height_in_blocks[i] = cinfo.comp_info[i].height_in_blocks;
      info->width_in_blocks[i] = cinfo.comp_info[i].width_in_blocks;
    }
    extract_quant(cinfo, 0, o.quant);
    if (cinfo.num_components > 1) {
      extract_quant(cinfo, 1, o.quant + kDct2);
      extract_quant(cinfo, 2, o.quant + 2 * kDct2);
    } else {
      for (int i = kDct2; i < 3 * kDct2; ++i) o.quant[i] = 1;
    }

    // the halved chroma windows below assume 4:2:0 (or grayscale)
    if (cinfo.num_components > 1 &&
        (cinfo.num_components != 3 ||
         info->height_in_blocks[1] != (info->height_in_blocks[0] + 1) / 2 ||
         info->width_in_blocks[1] != (info->width_in_blocks[0] + 1) / 2)) {
      *msg = "RGB cropped wire needs 4:2:0 chroma (stage_dataset re-encodes)";
      jpeg_destroy_decompress(&cinfo);
      fclose(f);
      return false;
    }

    const long H = cinfo.image_height, W = cinfo.image_width;
    double py, px, ph, pw;  // pixel box (float: eval boxes are fractional)
    if (mode == kRgbTrain) {
      long bi, bj, bh, bw;
      sample_rrc_pixel_box(H, W, uniforms, scale_lo, scale_hi, &bi, &bj, &bh, &bw);
      py = bi; px = bj; ph = bh; pw = bw;
    } else if (mode == kRgbCenter) {
      // Resize(resize_to) short side + CenterCrop(crop) == center box of
      // crop * min(H,W) / resize_to source pixels (datasets.py:328-329)
      const double s = crop * std::min(H, W) / resize_to;
      py = (H - s) / 2.0; px = (W - s) / 2.0; ph = s; pw = s;
    } else {  // whole-image (swin val Resize only, datasets.py:347)
      py = 0; px = 0; ph = H; pw = W;
    }

    long wy0, wx0, wbh, wbw;
    int fy, fx;
    if (!window_axis(py, ph, t, &wy0, &wbh, &fy) ||
        !window_axis(px, pw, t, &wx0, &wbw, &fx)) {
      ok = false;
      *msg = "image too large for the cropped RGB wire (needs f > 4)";
    } else {
      win_out[0] = wy0; win_out[1] = wx0; win_out[2] = wbh; win_out[3] = wbw;
      win_out[4] = fy; win_out[5] = fx;
      geom[0] = static_cast<float>((py - wy0 * 8.0) / fy);
      geom[1] = static_cast<float>(ph / fy);
      geom[2] = static_cast<float>((px - wx0 * 8.0) / fx);
      geom[3] = static_cast<float>(pw / fx);

      thread_local std::vector<float> win, tmp, out, gt, grp;
      const bool prof2 = g_prof_enabled.load(std::memory_order_relaxed);
      uint64_t te0 = prof2 ? prof_now() : 0;
      const float* plane;
      // luma OOB fill -1024: out-of-image slivers inside the rounded-up
      // window decode to black like the rest of the wire (chroma stays 0 =
      // neutral, which IS black's chroma)
      extract_downsample(cinfo, arrays, 0, o.quant, wy0, wx0, wbh, wbw, fy, fx,
                         g2, g4, &win, &tmp, &out, &gt, &grp, &plane, -1024.f);
      uint64_t tp0 = 0;
      if (prof2) {
        tp0 = prof_now();
        g_prof.extract_resize.fetch_add(tp0 - te0, std::memory_order_relaxed);
      }
      pack_plane_rect_mask16(plane, wbh / fy, wbw / fx, t, k, o.vy, o.my, o.sy,
                             o.dy);
      if (prof2)
        g_prof.pack.fetch_add(prof_now() - tp0, std::memory_order_relaxed);

      if (cinfo.num_components > 1) {
        thread_local std::vector<float> cwin, ctmp, cout;
        for (int comp = 1; comp < 3; ++comp) {
          uint64_t ce0 = prof2 ? prof_now() : 0;
          const float* cplane;
          extract_downsample(cinfo, arrays, comp, o.quant + comp * kDct2,
                             wy0 / 2, wx0 / 2, wbh / 2, wbw / 2, fy, fx, g2,
                             g4, &cwin, &ctmp, &cout, &gt, &grp, &cplane);
          uint64_t cp0 = 0;
          if (prof2) {
            cp0 = prof_now();
            g_prof.extract_resize.fetch_add(cp0 - ce0, std::memory_order_relaxed);
          }
          const size_t plane_n = static_cast<size_t>(t_c) * t_c;
          const size_t po = (comp - 1) * plane_n;
          pack_plane_rect_mask16(cplane, wbh / 2 / fy, wbw / 2 / fx, t_c, k,
                                 o.vc + po * k, o.mc + po * 8, o.sc + po,
                                 o.dc + po);
          if (prof2)
            g_prof.pack.fetch_add(prof_now() - cp0, std::memory_order_relaxed);
        }
      }
      jpeg_finish_decompress(&cinfo);
    }
  }
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return ok;
}

// --- read_crop_resize_pack(path, k, mode, t_y, t_c, max_src, uniforms,
//         scale_lo, scale_hi, ratio, evens, spec, data,
//         vy, my, sy, dy, vc, mc, sc, dc, quant)
//     -> (ncomp, yh, yw, ch, cw, bi, bj, bh, bw) ------------------------------
PyObject* py_read_crop_resize_pack(PyObject*, PyObject* args) {
  const char* path;
  int k, mode, t_y, t_c, max_src;
  int wide = 0, requant = 0;
  double scale_lo, scale_hi, ratio;
  Py_buffer ub, eb, sb, db, vy, my, sy, dy, vc, mc, sc, dcc, qb;
  if (!PyArg_ParseTuple(args, "siiiiiw*dddw*w*w*w*w*w*w*w*w*w*w*w*|ii", &path,
                        &k, &mode, &t_y, &t_c, &max_src, &ub, &scale_lo,
                        &scale_hi, &ratio, &eb, &sb, &db, &vy, &my, &sy, &dy,
                        &vc, &mc, &sc, &dcc, &qb, &wide, &requant))
    return nullptr;

  std::vector<Py_buffer*> bufs = {&ub, &eb, &sb, &db, &vy, &my, &sy,
                                  &dy, &vc, &mc, &sc, &dcc, &qb};
  auto fail = [&](PyObject* exc, const char* m) -> PyObject* {
    for (auto* b : bufs) PyBuffer_Release(b);
    PyErr_SetString(exc, m);
    return nullptr;
  };

  const size_t yblk = static_cast<size_t>(t_y) * t_y;
  const size_t cblk = 2 * static_cast<size_t>(t_c) * t_c;
  const int n_evens = static_cast<int>(eb.len / sizeof(int32_t));
  const size_t n_spec = sb.len / (10 * sizeof(int32_t));
  if (ub.len < 12 * static_cast<Py_ssize_t>(sizeof(double)) || n_evens < 1 ||
      n_spec < static_cast<size_t>(max_src))
    return fail(PyExc_ValueError, "uniforms/evens/spec buffers too small");
  const size_t vsz = wide ? 2 : 1;
  if (static_cast<size_t>(vy.len) < yblk * k * vsz || static_cast<size_t>(my.len) < yblk * 8 ||
      static_cast<size_t>(sy.len) < yblk ||
      static_cast<size_t>(dy.len) < yblk * sizeof(int16_t) ||
      static_cast<size_t>(vc.len) < cblk * k * vsz || static_cast<size_t>(mc.len) < cblk * 8 ||
      static_cast<size_t>(sc.len) < cblk ||
      static_cast<size_t>(dcc.len) < cblk * sizeof(int16_t) ||
      static_cast<size_t>(qb.len) < 3 * kDct2 * sizeof(int16_t))
    return fail(PyExc_ValueError, "packed output buffer too small");

  CropPackPtrs o{static_cast<int8_t*>(vy.buf), static_cast<uint8_t*>(my.buf),
                 static_cast<uint8_t*>(sy.buf), static_cast<int16_t*>(dy.buf),
                 static_cast<int8_t*>(vc.buf), static_cast<uint8_t*>(mc.buf),
                 static_cast<uint8_t*>(sc.buf), static_cast<int16_t*>(dcc.buf),
                 static_cast<int16_t*>(qb.buf)};
  CoeffInfo info;
  long box[4] = {0, 0, 0, 0};
  std::string msg;
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = crop_pack_core(path, k, static_cast<CropMode>(mode), t_y, t_c, max_src,
                      static_cast<const double*>(ub.buf), scale_lo, scale_hi,
                      ratio, static_cast<const int32_t*>(eb.buf), n_evens,
                      static_cast<const int32_t*>(sb.buf), n_spec,
                      static_cast<const float*>(db.buf), db.len / sizeof(float),
                      o, &info, box, &msg, wide != 0, requant != 0);
  Py_END_ALLOW_THREADS;

  for (auto* b : bufs) PyBuffer_Release(b);
  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "crop_resize_pack: %s (%s)", msg.c_str(), path);
    return nullptr;
  }
  return Py_BuildValue("iiiiillll", info.num_components, info.height_in_blocks[0],
                       info.width_in_blocks[0], info.height_in_blocks[1],
                       info.width_in_blocks[1], box[0], box[1], box[2], box[3]);
}

// --- read_crop_resize_pack_row(path, k, mode, t_y, t_c, max_src, uniforms,
//         scale_lo, scale_hi, ratio, evens, spec, data, row, offsets,
//         label, weight) -> (ncomp, yh, yw, ch, cw, bi, bj, bh, bw) -----------
// Loader hot-path variant: all per-sample outputs live in ONE consolidated
// row buffer (data.loader.packed_layout); `offsets` is int64 (11,) with byte
// offsets [vy, my, sy, dy, vc, mc, sc, dc, quant, labels, weights].  The
// label/weight are written into the row here, so the Python worker makes a
// single call with zero numpy view objects per image.
PyObject* py_read_crop_resize_pack_row(PyObject*, PyObject* args) {
  const char* path;
  int k, mode, t_y, t_c, max_src;
  int wide = 0, requant = 0;
  double scale_lo, scale_hi, ratio, weight;
  long label;
  Py_buffer ub, eb, sb, db, rb, ob;
  if (!PyArg_ParseTuple(args, "siiiiiw*dddw*w*w*w*w*ld|ii", &path, &k, &mode,
                        &t_y, &t_c, &max_src, &ub, &scale_lo, &scale_hi, &ratio,
                        &eb, &sb, &db, &rb, &ob, &label, &weight, &wide,
                        &requant))
    return nullptr;

  std::vector<Py_buffer*> bufs = {&ub, &eb, &sb, &db, &rb, &ob};
  auto fail = [&](PyObject* exc, const char* m) -> PyObject* {
    for (auto* b : bufs) PyBuffer_Release(b);
    PyErr_SetString(exc, m);
    return nullptr;
  };

  const size_t yblk = static_cast<size_t>(t_y) * t_y;
  const size_t cblk = 2 * static_cast<size_t>(t_c) * t_c;
  const int n_evens = static_cast<int>(eb.len / sizeof(int32_t));
  const size_t n_spec = sb.len / (10 * sizeof(int32_t));
  if (ub.len < 12 * static_cast<Py_ssize_t>(sizeof(double)) || n_evens < 1 ||
      n_spec < static_cast<size_t>(max_src) ||
      static_cast<size_t>(ob.len) < 11 * sizeof(int64_t))
    return fail(PyExc_ValueError, "uniforms/evens/spec/offsets too small");
  const int64_t* off = static_cast<const int64_t*>(ob.buf);
  const size_t vsz = wide ? 2 : 1;
  // field extents (bytes) in offset order, for the bounds check
  const size_t ext[11] = {yblk * k * vsz, yblk * 8, yblk, yblk * 2,
                          cblk * k * vsz, cblk * 8, cblk, cblk * 2,
                          3 * kDct2 * 2, 4, 4};
  for (int i = 0; i < 11; ++i) {
    if (off[i] < 0 || static_cast<size_t>(off[i]) + ext[i] > static_cast<size_t>(rb.len))
      return fail(PyExc_ValueError, "row offsets out of bounds");
  }
  uint8_t* row = static_cast<uint8_t*>(rb.buf);
  CropPackPtrs o{reinterpret_cast<int8_t*>(row + off[0]), row + off[1],
                 row + off[2], reinterpret_cast<int16_t*>(row + off[3]),
                 reinterpret_cast<int8_t*>(row + off[4]), row + off[5],
                 row + off[6], reinterpret_cast<int16_t*>(row + off[7]),
                 reinterpret_cast<int16_t*>(row + off[8])};
  CoeffInfo info;
  long box[4] = {0, 0, 0, 0};
  std::string msg;
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = crop_pack_core(path, k, static_cast<CropMode>(mode), t_y, t_c, max_src,
                      static_cast<const double*>(ub.buf), scale_lo, scale_hi,
                      ratio, static_cast<const int32_t*>(eb.buf), n_evens,
                      static_cast<const int32_t*>(sb.buf), n_spec,
                      static_cast<const float*>(db.buf), db.len / sizeof(float),
                      o, &info, box, &msg, wide != 0, requant != 0);
  if (ok) {
    int32_t lab = static_cast<int32_t>(label);
    float w = static_cast<float>(weight);
    std::memcpy(row + off[9], &lab, sizeof(lab));
    std::memcpy(row + off[10], &w, sizeof(w));
  }
  Py_END_ALLOW_THREADS;

  for (auto* b : bufs) PyBuffer_Release(b);
  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "crop_resize_pack: %s (%s)", msg.c_str(), path);
    return nullptr;
  }
  return Py_BuildValue("iiiiillll", info.num_components, info.height_in_blocks[0],
                       info.width_in_blocks[0], info.height_in_blocks[1],
                       info.width_in_blocks[1], box[0], box[1], box[2], box[3]);
}

// --- read_rgb_crop_pack_row(path, k, t, mode, uniforms, scale_lo, scale_hi,
//         resize_to, crop, g2, g4, row, offsets, label, weight)
//     -> (ncomp, H, W, wy0, wx0, wbh, wbw, fy, fx) ----------------------------
// RGB crop-before-pack loader hot path.  `offsets` is int64 (12,): the 11
// standard row fields + a trailing [geom] offset (4 f32: sy0, sh, sx0, sw in
// downsampled-window pixels for the device's residual bilinear resample).
// g2/g4: (8, 16)/(8, 32) f32 group blocks of resize_axis_operator(f, 1).
PyObject* py_read_rgb_crop_pack_row(PyObject*, PyObject* args) {
  const char* path;
  int k, t, mode;
  double scale_lo, scale_hi, resize_to, crop, weight;
  long label;
  Py_buffer ub, g2b, g4b, rb, ob;
  if (!PyArg_ParseTuple(args, "siiiw*ddddw*w*w*w*ld", &path, &k, &t, &mode, &ub,
                        &scale_lo, &scale_hi, &resize_to, &crop, &g2b, &g4b,
                        &rb, &ob, &label, &weight))
    return nullptr;

  std::vector<Py_buffer*> bufs = {&ub, &g2b, &g4b, &rb, &ob};
  auto fail = [&](PyObject* exc, const char* m) -> PyObject* {
    for (auto* b : bufs) PyBuffer_Release(b);
    PyErr_SetString(exc, m);
    return nullptr;
  };

  const int t_c = t / 2;
  const size_t yblk = static_cast<size_t>(t) * t;
  const size_t cblk = 2 * static_cast<size_t>(t_c) * t_c;
  if (t % 2 || ub.len < 22 * static_cast<Py_ssize_t>(sizeof(double)) ||
      static_cast<size_t>(g2b.len) < 8 * 16 * sizeof(float) ||
      static_cast<size_t>(g4b.len) < 8 * 32 * sizeof(float) ||
      static_cast<size_t>(ob.len) < 12 * sizeof(int64_t))
    return fail(PyExc_ValueError, "uniforms/g2/g4/offsets buffers too small");
  const int64_t* off = static_cast<const int64_t*>(ob.buf);
  const size_t ext[12] = {yblk * k, yblk * 8, yblk, yblk * 2, cblk * k,
                          cblk * 8, cblk, cblk * 2, 3 * kDct2 * 2, 4, 4, 16};
  for (int i = 0; i < 12; ++i) {
    if (off[i] < 0 || static_cast<size_t>(off[i]) + ext[i] > static_cast<size_t>(rb.len))
      return fail(PyExc_ValueError, "row offsets out of bounds");
  }
  uint8_t* row = static_cast<uint8_t*>(rb.buf);
  CropPackPtrs o{reinterpret_cast<int8_t*>(row + off[0]), row + off[1],
                 row + off[2], reinterpret_cast<int16_t*>(row + off[3]),
                 reinterpret_cast<int8_t*>(row + off[4]), row + off[5],
                 row + off[6], reinterpret_cast<int16_t*>(row + off[7]),
                 reinterpret_cast<int16_t*>(row + off[8])};
  CoeffInfo info;
  long win[6] = {0, 0, 0, 0, 1, 1};
  float geom[4] = {0, 0, 0, 0};
  std::string msg;
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = rgb_crop_pack_core(path, k, t, static_cast<RgbCropMode>(mode),
                          static_cast<const double*>(ub.buf), scale_lo,
                          scale_hi, resize_to, crop,
                          static_cast<const float*>(g2b.buf),
                          static_cast<const float*>(g4b.buf), o, &info, win,
                          geom, &msg);
  if (ok) {
    int32_t lab = static_cast<int32_t>(label);
    float w = static_cast<float>(weight);
    std::memcpy(row + off[9], &lab, sizeof(lab));
    std::memcpy(row + off[10], &w, sizeof(w));
    std::memcpy(row + off[11], geom, sizeof(geom));
  }
  Py_END_ALLOW_THREADS;

  for (auto* b : bufs) PyBuffer_Release(b);
  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "rgb_crop_pack: %s (%s)", msg.c_str(), path);
    return nullptr;
  }
  return Py_BuildValue("iiillllll", info.num_components,
                       static_cast<int>(info.height_in_blocks[0]),
                       static_cast<int>(info.width_in_blocks[0]), win[0],
                       win[1], win[2], win[3], win[4], win[5]);
}

PyObject* py_read_into_packed(PyObject*, PyObject* args) {
  return read_into_packed_impl(args, kPackIndex);
}

PyObject* py_read_into_packed_mask(PyObject*, PyObject* args) {
  return read_into_packed_impl(args, kPackMask);
}

PyObject* py_read_into_packed_mask16(PyObject*, PyObject* args) {
  return read_into_packed_impl(args, kPackMask16);
}

// --- write_coefficients(path, img_h, img_w, quant_buf, y_buf, y_hb, y_wb,
//                        c_buf|None, c_hb, c_wb) ------------------------------
PyObject* py_write_coefficients(PyObject*, PyObject* args) {
  const char* path;
  int img_h, img_w, y_hb, y_wb, c_hb, c_wb;
  Py_buffer qb, yb;
  PyObject* cobj;
  if (!PyArg_ParseTuple(args, "siiy*y*iiOii", &path, &img_h, &img_w, &qb, &yb,
                        &y_hb, &y_wb, &cobj, &c_hb, &c_wb))
    return nullptr;

  Py_buffer cb{};
  bool color = cobj != Py_None;
  if (color && PyObject_GetBuffer(cobj, &cb, PyBUF_SIMPLE) != 0) {
    PyBuffer_Release(&qb);
    PyBuffer_Release(&yb);
    return nullptr;
  }

  std::string msg;
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = compress_coefficients(path, nullptr, nullptr, img_h, img_w, color,
                             static_cast<const int16_t*>(qb.buf), -1,
                             static_cast<const int16_t*>(yb.buf),
                             color ? static_cast<const int16_t*>(cb.buf) : nullptr,
                             c_hb, c_wb, &msg);
  Py_END_ALLOW_THREADS;

  PyBuffer_Release(&qb);
  PyBuffer_Release(&yb);
  if (color) PyBuffer_Release(&cb);
  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "libjpeg: %s", msg.c_str());
    return nullptr;
  }
  Py_RETURN_NONE;
}

// --- quantize_at_quality(pixels_buf, c, h, w, quality) ----------------------
// Compress CHW uint8 pixels to an in-memory JPEG at `quality`, then read its
// coefficients back.  Returns the same tuple as read_coefficients.
PyObject* py_quantize_at_quality(PyObject*, PyObject* args) {
  Py_buffer pb;
  int c, h, w, quality;
  if (!PyArg_ParseTuple(args, "y*iiii", &pb, &c, &h, &w, &quality)) return nullptr;
  if (static_cast<size_t>(pb.len) < static_cast<size_t>(c) * h * w) {
    PyBuffer_Release(&pb);
    PyErr_SetString(PyExc_ValueError, "pixel buffer too small");
    return nullptr;
  }

  unsigned char* membuf = nullptr;
  unsigned long memsize = 0;
  std::string msg;
  bool ok = true;

  std::vector<int16_t> ybuf, cbuf;
  int16_t quant[3 * kDct2];
  CoeffInfo info;

  Py_BEGIN_ALLOW_THREADS;
  {
    // encode
    jpeg_compress_struct cinfo{};
    ErrorMgr err{};
    cinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = error_exit;
    if (setjmp(err.jump)) {
      ok = false;
      msg = err.message;
      jpeg_destroy_compress(&cinfo);
    } else {
      jpeg_create_compress(&cinfo);
      jpeg_mem_dest(&cinfo, &membuf, &memsize);
      cinfo.image_width = w;
      cinfo.image_height = h;
      cinfo.input_components = c;
      cinfo.in_color_space = c > 1 ? JCS_RGB : JCS_GRAYSCALE;
      jpeg_set_defaults(&cinfo);
      jpeg_set_quality(&cinfo, quality, TRUE);
      std::vector<uint8_t> inter =
          interleave_chw(static_cast<const uint8_t*>(pb.buf), c, h, w);
      jpeg_start_compress(&cinfo, TRUE);
      size_t stride = static_cast<size_t>(c) * w;
      while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = inter.data() + cinfo.next_scanline * stride;
        jpeg_write_scanlines(&cinfo, &row, 1);
      }
      jpeg_finish_compress(&cinfo);
      jpeg_destroy_compress(&cinfo);
    }
    // decode coefficients from memory
    if (ok) {
      jpeg_decompress_struct dinfo{};
      ErrorMgr derr{};
      dinfo.err = jpeg_std_error(&derr.pub);
      derr.pub.error_exit = error_exit;
      if (setjmp(derr.jump)) {
        ok = false;
        msg = derr.message;
      } else {
        jpeg_create_decompress(&dinfo);
        jpeg_mem_src(&dinfo, membuf, memsize);
        jpeg_read_header(&dinfo, TRUE);
        int yh = dinfo.comp_info[0].height_in_blocks;
        int yw = dinfo.comp_info[0].width_in_blocks;
        ybuf.resize(static_cast<size_t>(yh) * yw * kDct2);
        int chh = 0, cww = 0;
        if (dinfo.num_components > 1) {
          chh = dinfo.comp_info[1].height_in_blocks;
          cww = dinfo.comp_info[1].width_in_blocks;
          cbuf.resize(2 * static_cast<size_t>(chh) * cww * kDct2);
        }
        decode_coefficients(dinfo, &info, ybuf.data(), yh, yw, cbuf.data(), chh,
                            cww, quant);
      }
      jpeg_destroy_decompress(&dinfo);
    }
    if (membuf) free(membuf);
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&pb);

  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "libjpeg: %s", msg.c_str());
    return nullptr;
  }

  const int nc = info.num_components;
  std::vector<int32_t> dims(static_cast<size_t>(nc) * 2);
  for (int i = 0; i < nc; ++i) {
    dims[i * 2] = info.down_h[i];
    dims[i * 2 + 1] = info.down_w[i];
  }
  PyObject* dims_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(dims.data()), dims.size() * sizeof(int32_t));
  PyObject* quant_b =
      PyBytes_FromStringAndSize(reinterpret_cast<const char*>(quant), sizeof(quant));
  PyObject* y_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(ybuf.data()), ybuf.size() * sizeof(int16_t));
  if (nc > 1) {
    PyObject* c_b = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(cbuf.data()), cbuf.size() * sizeof(int16_t));
    return Py_BuildValue("i N N (i i N) (i i N)", nc, dims_b, quant_b,
                         info.height_in_blocks[0], info.width_in_blocks[0], y_b,
                         info.height_in_blocks[1], info.width_in_blocks[1], c_b);
  }
  return Py_BuildValue("i N N (i i N) O", nc, dims_b, quant_b,
                       info.height_in_blocks[0], info.width_in_blocks[0], y_b,
                       Py_None);
}

// --- write_tensor(path, pixels_buf, c, h, w, quant_buf|None, quality) -------
PyObject* py_write_tensor(PyObject*, PyObject* args) {
  const char* path;
  Py_buffer pb;
  int c, h, w, quality;
  PyObject* qobj;
  if (!PyArg_ParseTuple(args, "sy*iiiOi", &path, &pb, &c, &h, &w, &qobj, &quality))
    return nullptr;
  Py_buffer qb{};
  bool have_quant = qobj != Py_None;
  if (have_quant && PyObject_GetBuffer(qobj, &qb, PyBUF_SIMPLE) != 0) {
    PyBuffer_Release(&pb);
    return nullptr;
  }

  bool ok = true;
  std::string msg;
  Py_BEGIN_ALLOW_THREADS;
  {
    jpeg_compress_struct cinfo{};
    ErrorMgr err{};
    cinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = error_exit;
    FILE* f = fopen(path, "wb");
    if (!f) {
      ok = false;
      msg = std::string("Unable to open file for writing: ") + path;
    } else if (setjmp(err.jump)) {
      ok = false;
      msg = err.message;
      jpeg_destroy_compress(&cinfo);
      fclose(f);
    } else {
      jpeg_create_compress(&cinfo);
      jpeg_stdio_dest(&cinfo, f);
      cinfo.image_height = h;
      cinfo.image_width = w;
      cinfo.input_components = c;
      cinfo.in_color_space = (c == 3) ? JCS_RGB : JCS_GRAYSCALE;
      fill_extended_defaults(&cinfo);
      jpeg_set_quality(&cinfo, quality, TRUE);
      if (have_quant) set_quant_tables(&cinfo, static_cast<const int16_t*>(qb.buf), c);
      jpeg_start_compress(&cinfo, TRUE);
      std::vector<uint8_t> inter =
          interleave_chw(static_cast<const uint8_t*>(pb.buf), c, h, w);
      size_t stride = static_cast<size_t>(c) * w;
      while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = inter.data() + cinfo.next_scanline * stride;
        jpeg_write_scanlines(&cinfo, &row, 1);
      }
      jpeg_finish_compress(&cinfo);
      jpeg_destroy_compress(&cinfo);
      fclose(f);
    }
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&pb);
  if (have_quant) PyBuffer_Release(&qb);
  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "libjpeg: %s", msg.c_str());
    return nullptr;
  }
  Py_RETURN_NONE;
}

// --- read_jpeg(path) -> (c, h, w, bytes) ------------------------------------
PyObject* py_read_jpeg(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  std::vector<uint8_t> out;
  int c, h, w;
  std::string msg;
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = decompress_pixels(path, nullptr, 0, &out, &c, &h, &w, &msg);
  Py_END_ALLOW_THREADS;
  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "libjpeg: %s", msg.c_str());
    return nullptr;
  }
  PyObject* b = PyBytes_FromStringAndSize(reinterpret_cast<const char*>(out.data()),
                                          out.size());
  return Py_BuildValue("iiiN", c, h, w, b);
}

// --- decode_coeff(img_h, img_w, quant_buf, quality, y_buf, y_hb, y_wb,
//                  c_buf|None, c_hb, c_wb) -> (c, h, w, bytes) ---------------
PyObject* py_decode_coeff(PyObject*, PyObject* args) {
  int img_h, img_w, quality, y_hb, y_wb, c_hb, c_wb;
  Py_buffer qb, yb;
  PyObject* cobj;
  if (!PyArg_ParseTuple(args, "iiy*iy*iiOii", &img_h, &img_w, &qb, &quality, &yb,
                        &y_hb, &y_wb, &cobj, &c_hb, &c_wb))
    return nullptr;
  Py_buffer cb{};
  bool color = cobj != Py_None;
  if (color && PyObject_GetBuffer(cobj, &cb, PyBUF_SIMPLE) != 0) {
    PyBuffer_Release(&qb);
    PyBuffer_Release(&yb);
    return nullptr;
  }

  unsigned char* membuf = nullptr;
  unsigned long memsize = 0;
  std::vector<uint8_t> out;
  int c = 0, h = 0, w = 0;
  std::string msg;
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = compress_coefficients(nullptr, &membuf, &memsize, img_h, img_w, color,
                             static_cast<const int16_t*>(qb.buf), quality,
                             static_cast<const int16_t*>(yb.buf),
                             color ? static_cast<const int16_t*>(cb.buf) : nullptr,
                             c_hb, c_wb, &msg);
  if (ok) ok = decompress_pixels(nullptr, membuf, memsize, &out, &c, &h, &w, &msg);
  if (membuf) free(membuf);
  Py_END_ALLOW_THREADS;

  PyBuffer_Release(&qb);
  PyBuffer_Release(&yb);
  if (color) PyBuffer_Release(&cb);
  if (!ok) {
    PyErr_Format(PyExc_RuntimeError, "libjpeg: %s", msg.c_str());
    return nullptr;
  }
  PyObject* b = PyBytes_FromStringAndSize(reinterpret_cast<const char*>(out.data()),
                                          out.size());
  return Py_BuildValue("iiiN", c, h, w, b);
}

PyObject* py_crop_profile(PyObject*, PyObject* args) {
  // crop_profile(enable: int) -> dict of accumulated per-stage nanoseconds.
  // Reads + resets the counters; pass enable=1 before a measured run.
  int enable = -1;
  if (!PyArg_ParseTuple(args, "|i", &enable)) return nullptr;
  if (enable >= 0) g_prof_enabled.store(enable != 0, std::memory_order_relaxed);
  uint64_t dec = g_prof.decode.exchange(0, std::memory_order_relaxed);
  uint64_t ext = g_prof.extract_resize.exchange(0, std::memory_order_relaxed);
  uint64_t pak = g_prof.pack.exchange(0, std::memory_order_relaxed);
  uint64_t n = g_prof.n.exchange(0, std::memory_order_relaxed);
  return Py_BuildValue("{s:K,s:K,s:K,s:K}", "decode_ns", dec,
                       "extract_resize_ns", ext, "pack_ns", pak, "n", n);
}

PyObject* py_pack_debug(PyObject*, PyObject* args) {
  // pack_debug(block_f32_64, k, use_scalar) -> (values bytes(k), mask
  // bytes(8), scale, dc).  Test hook: runs ONE block through the mask16
  // packer — the dispatched (AVX-512 where built) path or the scalar
  // oracle — so tests/test_ksweep.py can pin the two bit-identical.
  Py_buffer blk;
  int k, use_scalar;
  if (!PyArg_ParseTuple(args, "w*ii", &blk, &k, &use_scalar)) return nullptr;
  if (blk.len != 64 * static_cast<Py_ssize_t>(sizeof(float)) || k < 1 || k > 63) {
    PyBuffer_Release(&blk);
    PyErr_SetString(PyExc_ValueError, "need 64 f32 and 1 <= k <= 63");
    return nullptr;
  }
  std::vector<int8_t> values(k, 0);
  uint8_t mask[8] = {0};
  uint8_t scale = 0;
  int16_t dc = 0;
  const float* rows = static_cast<const float*>(blk.buf);
  if (use_scalar)
    pack_block_topk_mask16_f32_scalar(rows, 8, k, values.data(), mask, &scale, &dc);
  else
    pack_block_topk_mask16_f32(rows, 8, k, values.data(), mask, &scale, &dc);
  PyBuffer_Release(&blk);
  return Py_BuildValue("y#y#ii", reinterpret_cast<char*>(values.data()),
                       static_cast<Py_ssize_t>(k), reinterpret_cast<char*>(mask),
                       static_cast<Py_ssize_t>(8), static_cast<int>(scale),
                       static_cast<int>(dc));
}

PyMethodDef methods[] = {
    {"pack_debug", py_pack_debug, METH_VARARGS,
     "One-block mask16 pack through the dispatched or scalar path (test hook)."},
    {"crop_profile", py_crop_profile, METH_VARARGS,
     "Enable/disable the crop-path stage profiler; returns+resets counters."},
    {"read_coefficients", py_read_coefficients, METH_VARARGS,
     "Entropy-decode DCT coefficients from a JPEG file."},
    {"read_into_canvas", py_read_into_canvas, METH_VARARGS,
     "Entropy-decode DCT coefficients into preallocated int16 canvases."},
    {"read_into_packed", py_read_into_packed, METH_VARARGS,
     "Entropy-decode + sparse top-K pack into int8/uint8 canvases."},
    {"read_into_packed_mask", py_read_into_packed_mask, METH_VARARGS,
     "Top-K pack with 8-byte occupancy bitmasks (25 B/block at K=16)."},
    {"read_into_packed_mask16", py_read_into_packed_mask16, METH_VARARGS,
     "Bitmask pack with exact int16 DC + int8 top-K ACs (K+11 B/block)."},
    {"read_crop_resize_pack", py_read_crop_resize_pack, METH_VARARGS,
     "Decode + host crop/resize to the target grid + mask16 pack."},
    {"read_crop_resize_pack_row", py_read_crop_resize_pack_row, METH_VARARGS,
     "Crop/resize/pack into one consolidated row buffer (loader hot path)."},
    {"read_rgb_crop_pack_row", py_read_rgb_crop_pack_row, METH_VARARGS,
     "RGB crop-before-pack: pixel box window + {1,2,4} spectral downsample."},
    {"write_coefficients", py_write_coefficients, METH_VARARGS,
     "Write DCT coefficients to a JPEG file."},
    {"quantize_at_quality", py_quantize_at_quality, METH_VARARGS,
     "Encode CHW uint8 pixels at a quality and return their coefficients."},
    {"write_tensor", py_write_tensor, METH_VARARGS,
     "Encode CHW uint8 pixels to a JPEG file."},
    {"read_jpeg", py_read_jpeg, METH_VARARGS, "Full decode of a JPEG to CHW uint8."},
    {"decode_coeff", py_decode_coeff, METH_VARARGS,
     "Decode DCT coefficients to CHW uint8 pixels."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_dctcodec",
                      "libjpeg DCT coefficient codec", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__dctcodec(void) { return PyModule_Create(&module); }
