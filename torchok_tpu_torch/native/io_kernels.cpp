// JPEG decoding for the data pipeline of torchok_tpu_torch: the libjpeg path
// of torchok_tpu/native/io_kernels.cpp, as a plain C ABI with no Python
// dependency, so the ctypes call releases the GIL and loader threads decode
// in parallel. PNG files are decoded in Python (zlib + numpy) and need no
// library here.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 io_kernels.cpp -ljpeg -o libtorchok_jpeg.so
// (driven by torchok_tpu_torch/native/build.py, cached by content hash).

#include <csetjmp>
#include <cstdint>
#include <cstdio>

#include <jpeglib.h>

extern "C" {

// libjpeg reports errors through a longjmp (no exceptions across the C ABI)
struct JpegErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

static void jpeg_error_exit(j_common_ptr cinfo) {
    JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
    longjmp(err->setjmp_buffer, 1);
}

// Width and height of a JPEG; it decodes to 3 channels (RGB) whatever its
// colour space.
int tkio_jpeg_info(const uint8_t* data, int64_t size, int* width, int* height,
                   int* channels) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(size));
    jpeg_read_header(&cinfo, TRUE);
    *width = static_cast<int>(cinfo.image_width);
    *height = static_cast<int>(cinfo.image_height);
    *channels = 3;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode a JPEG into a caller-allocated RGB (H, W, 3) uint8 buffer.
int tkio_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int out_h, int out_w) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(size));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_width) != out_w ||
        static_cast<int>(cinfo.output_height) != out_h || cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    const int stride = out_w * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + static_cast<int64_t>(cinfo.output_scanline) * stride;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

}  // extern "C"
