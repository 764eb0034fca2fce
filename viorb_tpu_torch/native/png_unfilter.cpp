// PNG row reconstruction (PNG specification, section 9.2) for
// viorb_tpu_torch/io/png.py: undoes the five filter types of every row of
// a decompressed image. Average and Paeth depend on the byte to their left,
// so a row is one serial pass; this keeps that pass off the interpreter.
// Built with g++ at first use by viorb_tpu_torch/native/__init__.py and
// called through ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// rows: h rows of 1 + stride bytes (the row's filter type, then its
// filtered bytes); bpp: bytes a pixel (at least 1); out: h * stride
// reconstructed bytes. Returns -1, or the first row whose filter type is
// not 0-4 (the rows before it are reconstructed).
int64_t png_unfilter(const uint8_t* rows, int64_t h, int64_t stride, int64_t bpp, uint8_t* out) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t kind = rows[y * (stride + 1)];
        const uint8_t* in = rows + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        const uint8_t* up = y > 0 ? cur - stride : nullptr;  // the row above, reconstructed
        switch (kind) {
            case 0:
                std::memcpy(cur, in, stride);
                break;
            case 1:  // Sub
                for (int64_t x = 0; x < stride; ++x)
                    cur[x] = uint8_t(in[x] + (x >= bpp ? cur[x - bpp] : 0));
                break;
            case 2:  // Up
                for (int64_t x = 0; x < stride; ++x)
                    cur[x] = uint8_t(in[x] + (up ? up[x] : 0));
                break;
            case 3:  // Average
                for (int64_t x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? cur[x - bpp] : 0;
                    const int b = up ? up[x] : 0;
                    cur[x] = uint8_t(in[x] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? cur[x - bpp] : 0;
                    const int b = up ? up[x] : 0;
                    const int c = (up && x >= bpp) ? up[x - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    cur[x] = uint8_t(in[x] + pred);
                }
                break;
            default:
                return y;
        }
    }
    return -1;
}

}  // extern "C"
