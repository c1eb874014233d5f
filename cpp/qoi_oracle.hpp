// qoi_oracle — clean-room C++17 implementation of the QOI bitstream.
//
// Role in this project (see SURVEY.md §2.4): host-side differential oracle for
// the device engine. Semantics follow the normative format description in the
// reference (/root/reference/qoi.h:61-207) and the behavioural contract probed
// in SURVEY.md §2.2-§2.3. This is an independent implementation, not a copy:
// vector-of-bytes output, RAII, std::span-style views, and a stateful
// StreamState object shared by encode and decode.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace qoi_oracle {

// Informative colorspace tags (reference qoi.h:229-234). Purely metadata.
enum class Colorspace : uint8_t { kSRGB = 0, kLinear = 1 };

struct ImageDesc {
  uint32_t width = 0;
  uint32_t height = 0;
  uint8_t channels = 0;    // 3 = RGB, 4 = RGBA
  uint8_t colorspace = 0;  // 0 or 1
};

// Implementation safety cap, mirroring the reference guard (qoi.h:332):
// at most 400M pixels so the worst-case 5 B/px stream stays under 2 GB.
inline constexpr uint64_t kMaxPixels = 400000000ull;
inline constexpr size_t kHeaderSize = 14;
inline constexpr size_t kTrailerSize = 8;

// Encode `pixels` (desc.width*desc.height*desc.channels bytes, row-major,
// interleaved) into a QOI byte stream. Returns an empty vector on invalid
// arguments (the reference returns NULL, qoi.h:364-372).
std::vector<uint8_t> encode(const uint8_t* pixels, const ImageDesc& desc);

// Decode a QOI byte stream. `want_channels` of 0 means "use the header's
// channel count"; 3 or 4 force the output layout while `out_desc` still
// reports the header values (reference qoi.h:523-525, probed in SURVEY §2.3).
// Returns empty vector on malformed header/arguments. Truncated chunk data is
// tolerated: missing pixels repeat the current pixel (qoi.h:544).
std::vector<uint8_t> decode(const uint8_t* data, size_t size,
                            ImageDesc& out_desc, int want_channels);

// Convenience file I/O (reference qoi.h:595-646 equivalents).
bool write_file(const char* path, const uint8_t* pixels, const ImageDesc& desc);
std::vector<uint8_t> read_file(const char* path, ImageDesc& out_desc,
                               int want_channels);

}  // namespace qoi_oracle
