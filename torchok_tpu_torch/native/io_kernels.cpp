// JPEG decoding and encoding for the data pipeline of torchok_tpu_torch: the
// libjpeg path of torchok_tpu/native/io_kernels.cpp, and the encoder that
// ImageCompression round-trips an image through, as a plain C ABI with no
// Python dependency, so the ctypes call releases the GIL and loader threads
// run in parallel. PNG files are decoded in Python (zlib + numpy) and need no
// library here.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 io_kernels.cpp -ljpeg -o libtorchok_jpeg.so
// (driven by torchok_tpu_torch/native/build.py, cached by content hash).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>

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

// Encode an (H, W, channels) uint8 image (1 channel: grayscale, 3: RGB) as
// a baseline JPEG of the given quality with libjpeg's defaults (4:2:0
// chroma, islow DCT, no optimised tables), as cv2.imencode(".jpg") writes
// it. The bytes are malloc'd into *out (free them with tkio_free).
int tkio_jpeg_encode(const uint8_t* pixels, int height, int width, int channels, int quality,
                     uint8_t** out, uint64_t* out_size) {
    jpeg_compress_struct cinfo;
    JpegErrorMgr jerr;
    unsigned char* buffer = nullptr;
    unsigned long size = 0;
    *out = nullptr;
    *out_size = 0;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_compress(&cinfo);
        free(buffer);
        return -1;
    }
    if (channels != 1 && channels != 3) return -2;
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &buffer, &size);
    cinfo.image_width = static_cast<JDIMENSION>(width);
    cinfo.image_height = static_cast<JDIMENSION>(height);
    cinfo.input_components = channels;
    cinfo.in_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    const int64_t stride = static_cast<int64_t>(width) * channels;
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = const_cast<uint8_t*>(pixels + cinfo.next_scanline * stride);
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    *out = buffer;
    *out_size = size;
    return 0;
}

void tkio_free(void* p) { free(p); }

}  // extern "C"
