// Native host-IO for the data pipeline: DCT-domain scaled JPEG decode.
//
// The reference's loader (cerberusdet/data/datasets.py:463-480) decodes every
// JPEG at FULL resolution with cv2.imread and then cv2.resize's the long side
// down to imgsz. For sources larger than the train/serve resolution that
// wastes most of the decode: libjpeg(-turbo) can apply the resize *inside*
// the inverse DCT (scale_num/8 for scale_num=1..16), producing an image at
// ~target resolution directly — fewer IDCTs, fewer samples written, no
// full-res buffer.
//
// The port's copy of cerberusdet_tpu/native/jpeg_io.cpp, byte for byte in
// what it computes, so that both packages decode a JPEG to the same pixels.
// Plain C ABI (driven from Python via ctypes; ctypes drops the GIL during
// the call, so the loader's decode threads run it in parallel).

#include <csetjmp>
#include <cstddef>
#include <cstdio>
#include <cstring>

// jpeglib.h requires size_t/FILE to be declared before inclusion
#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void on_emit(j_common_ptr, int) {}  // silence warnings

// Smallest DCT scale (scale_num/8, scale_num in 1..8) whose output long side
// is still >= max_long_side; 8/8 if the image is already small enough.
int pick_scale_num(int full_long, int max_long_side) {
  if (max_long_side <= 0 || full_long <= max_long_side) return 8;
  for (int num = 1; num < 8; ++num) {
    // ceil(full * num / 8) >= max_long_side
    long scaled = (static_cast<long>(full_long) * num + 7) / 8;
    if (scaled >= max_long_side) return num;
  }
  return 8;
}

bool start_decompress(jpeg_decompress_struct* cinfo, const unsigned char* data,
                      unsigned long len, int max_long_side) {
  jpeg_mem_src(cinfo, const_cast<unsigned char*>(data), len);
  if (jpeg_read_header(cinfo, TRUE) != JPEG_HEADER_OK) return false;
  int full_long = cinfo->image_width > cinfo->image_height
                      ? cinfo->image_width
                      : cinfo->image_height;
  cinfo->scale_num = pick_scale_num(full_long, max_long_side);
  cinfo->scale_denom = 8;
  cinfo->out_color_space = JCS_RGB;
  cinfo->dct_method = JDCT_ISLOW;  // quality parity with cv2's default
  jpeg_calc_output_dimensions(cinfo);
  return true;
}

}  // namespace

extern "C" {

// Header-only pass: report the scaled output dims (and full dims) that a
// decode with the same max_long_side would produce. Returns 0 on success.
int cdet_jpeg_scaled_dims(const unsigned char* data, unsigned long len,
                          int max_long_side, int* out_h, int* out_w,
                          int* full_h, int* full_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = on_emit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  if (!start_decompress(&cinfo, data, len, max_long_side)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  *out_h = static_cast<int>(cinfo.output_height);
  *out_w = static_cast<int>(cinfo.output_width);
  *full_h = static_cast<int>(cinfo.image_height);
  *full_w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode into caller-provided HWC RGB uint8 buffer of exactly
// out_h*out_w*3 bytes (dims from cdet_jpeg_scaled_dims with the same
// max_long_side). Returns 0 on success.
int cdet_decode_jpeg_scaled(const unsigned char* data, unsigned long len,
                            int max_long_side, unsigned char* out,
                            int out_h, int out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = on_emit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  if (!start_decompress(&cinfo, data, len, max_long_side)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jpeg_start_decompress(&cinfo);
  const unsigned long stride = static_cast<unsigned long>(out_w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
