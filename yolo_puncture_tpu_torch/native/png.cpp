// The five PNG row filters undone (PNG specification, section 9.2), for the
// port's PNG reader (utils/png.py decode_png).  Each row of `src` is one
// filter-type byte followed by `stride` filtered bytes; `bpp` is the bytes of
// one pixel.  Writes the h × stride reconstructed bytes to `out`.  Returns 0,
// or -1 for a filter type other than 0..4.

#include <cstdint>
#include <cstdlib>
#include <cstring>

static inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

extern "C" int png_unfilter(const uint8_t* src, int64_t h, int64_t stride, int64_t bpp, uint8_t* out) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t kind = src[y * (stride + 1)];
        const uint8_t* f = src + y * (stride + 1) + 1;
        uint8_t* r = out + y * stride;
        const uint8_t* p = y > 0 ? r - stride : nullptr;   // the row above, none for the first
        switch (kind) {
            case 0:
                std::memcpy(r, f, stride);
                break;
            case 1:
                for (int64_t i = 0; i < stride; ++i) r[i] = f[i] + (i >= bpp ? r[i - bpp] : 0);
                break;
            case 2:
                for (int64_t i = 0; i < stride; ++i) r[i] = f[i] + (p ? p[i] : 0);
                break;
            case 3:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? r[i - bpp] : 0, b = p ? p[i] : 0;
                    r[i] = f[i] + static_cast<uint8_t>((a + b) >> 1);
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? r[i - bpp] : 0, b = p ? p[i] : 0;
                    const int c = (i >= bpp && p) ? p[i - bpp] : 0;
                    r[i] = f[i] + paeth(a, b, c);
                }
                break;
            default:
                return -1;
        }
    }
    return 0;
}
