// dasp_tpu_torch native runtime: host-side audio I/O and batch loading.
//
// A copy of the JAX package's dasp_tpu/native/dasp_io.cpp (same C ABI,
// same ABI version), kept in the port so that the port loads nothing from
// the JAX package. It keeps the card fed from the host with a small
// dependency-free C++ core:
//
//   * RIFF/WAVE codec (PCM 8/16/24/32, IEEE float32/64, extensible) with
//     RANGE reads — a training clip is fetched with one header parse and
//     one pread-sized read of exactly the needed bytes, not a whole-file
//     decode per chunk (the scipy path re-reads the entire file for
//     every 131072-sample clip).
//   * A pthread batch loader: N worker threads fill one contiguous
//     float32 (batch, channels, frames) buffer directly from disk, no
//     GIL, no per-clip Python allocation.
//   * A chunk-peak scanner for silence-skipping dataset indexing
//     that streams the file once.
//
// Exposed as a C ABI for ctypes (dasp_tpu_torch/native/__init__.py builds
// and binds it; every entry point has a pure-Python fallback so the
// package works without a compiler).
//
// Error convention: functions return >=0 on success (frame counts) or a
// negative DASP_E_* code; dasp_strerror maps codes to messages.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#define DASP_E_OPEN -1     // cannot open file
#define DASP_E_FORMAT -2   // not a parseable RIFF/WAVE
#define DASP_E_UNSUPP -3   // unsupported sample format
#define DASP_E_RANGE -4    // read range outside the data chunk
#define DASP_E_IO -5       // short read / write failure
#define DASP_E_ARG -6      // bad argument

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;     // 1 = PCM int, 3 = IEEE float
  int64_t data_offset = 0; // byte offset of sample data
  int64_t num_frames = 0;
};

uint32_t rd_u32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const unsigned char* p) {
  return (uint16_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8));
}

// Walk the RIFF chunk list; fill info. Returns 0 or a DASP_E_* code.
int parse_header(std::FILE* f, WavInfo* info) {
  unsigned char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12) return DASP_E_FORMAT;
  if (std::memcmp(hdr, "RIFF", 4) != 0 || std::memcmp(hdr + 8, "WAVE", 4) != 0)
    return DASP_E_FORMAT;
  bool have_fmt = false;
  for (;;) {
    unsigned char ck[8];
    if (std::fread(ck, 1, 8, f) != 8) break;
    uint32_t size = rd_u32(ck + 4);
    if (std::memcmp(ck, "fmt ", 4) == 0) {
      unsigned char fmt[40];
      size_t take = size < sizeof(fmt) ? size : sizeof(fmt);
      if (std::fread(fmt, 1, take, f) != take) return DASP_E_FORMAT;
      if (take < 16) return DASP_E_FORMAT;
      info->format = rd_u16(fmt);
      info->channels = rd_u16(fmt + 2);
      info->sample_rate = rd_u32(fmt + 4);
      info->bits = rd_u16(fmt + 14);
      if (info->format == 0xFFFE && take >= 26) // WAVE_FORMAT_EXTENSIBLE
        info->format = rd_u16(fmt + 24);        // first 2 bytes of SubFormat GUID
      // skip the unread remainder plus the RIFF word-alignment pad byte
      int64_t skip = (int64_t)(size - take) + (size & 1);
      if (skip > 0 && std::fseek(f, (long)skip, SEEK_CUR) != 0)
        return DASP_E_FORMAT;
      have_fmt = true;
    } else if (std::memcmp(ck, "data", 4) == 0) {
      if (!have_fmt) return DASP_E_FORMAT;
      long pos = std::ftell(f);
      if (pos < 0) return DASP_E_FORMAT;
      info->data_offset = pos;
      int64_t bytes_per_frame = (int64_t)info->channels * (info->bits / 8);
      if (bytes_per_frame <= 0) return DASP_E_FORMAT;
      int64_t data_bytes = size;
      // Streamed writers leave size 0/-1, and truncated files claim
      // more than exists: clamp to the real file tail so range reads
      // see only decodable frames. Known limitation: if a streamed
      // writer appended chunks (LIST/INFO) AFTER an unsized data
      // chunk, those trailing bytes are treated as audio.
      if (std::fseek(f, 0, SEEK_END) != 0) return DASP_E_FORMAT;
      int64_t tail = std::ftell(f) - info->data_offset;
      if (tail < 0) tail = 0;
      if (data_bytes == 0 || data_bytes == (int64_t)0xFFFFFFFF ||
          data_bytes > tail)
        data_bytes = tail;
      info->num_frames = data_bytes / bytes_per_frame;
      return 0;
    } else {
      // skip unknown chunk (word-aligned)
      if (std::fseek(f, (long)(size + (size & 1)), SEEK_CUR) != 0)
        return DASP_E_FORMAT;
    }
  }
  return DASP_E_FORMAT;
}

bool format_supported(const WavInfo& w) {
  if (w.format == 1) return w.bits == 8 || w.bits == 16 || w.bits == 24 || w.bits == 32;
  if (w.format == 3) return w.bits == 32 || w.bits == 64;
  return false;
}

// Convert `frames` interleaved frames of raw bytes to deinterleaved
// float32 (channels-major: out[c * frames + t]). `take_ch` <= w.channels.
void convert(const unsigned char* raw, const WavInfo& w, int64_t frames,
             int take_ch, float* out) {
  const int bpspl = w.bits / 8;
  const int64_t stride = (int64_t)w.channels * bpspl;
  for (int c = 0; c < take_ch; c++) {
    float* dst = out + (int64_t)c * frames;
    const unsigned char* src = raw + (int64_t)c * bpspl;
    if (w.format == 1 && w.bits == 16) {
      for (int64_t t = 0; t < frames; t++) {
        int16_t v;
        std::memcpy(&v, src + t * stride, 2);
        dst[t] = (float)v / 32768.0f;
      }
    } else if (w.format == 1 && w.bits == 24) {
      for (int64_t t = 0; t < frames; t++) {
        const unsigned char* p = src + t * stride;
        // assemble in unsigned (shifting set bits into a signed sign
        // bit is UB pre-C++20), then sign-extend via the int32 cast
        int32_t v = (int32_t)(((uint32_t)p[0] << 8) | ((uint32_t)p[1] << 16) |
                              ((uint32_t)p[2] << 24));
        dst[t] = (float)(v >> 8) / 8388608.0f;
      }
    } else if (w.format == 1 && w.bits == 32) {
      for (int64_t t = 0; t < frames; t++) {
        int32_t v;
        std::memcpy(&v, src + t * stride, 4);
        dst[t] = (float)((double)v / 2147483648.0);
      }
    } else if (w.format == 1 && w.bits == 8) { // unsigned per WAV spec
      for (int64_t t = 0; t < frames; t++)
        dst[t] = ((float)src[t * stride] - 128.0f) / 128.0f;
    } else if (w.format == 3 && w.bits == 32) {
      for (int64_t t = 0; t < frames; t++)
        std::memcpy(&dst[t], src + t * stride, 4);
    } else { // format 3, 64-bit
      for (int64_t t = 0; t < frames; t++) {
        double v;
        std::memcpy(&v, src + t * stride, 8);
        dst[t] = (float)v;
      }
    }
  }
}

// Read frames [offset, offset+frames) into deinterleaved float32.
// Missing tail (clip runs past EOF) is zero-filled. Returns frames
// actually decoded (>=0) or DASP_E_*.
int64_t read_range(const char* path, int64_t offset, int64_t frames,
                   int take_ch, float* out, WavInfo* out_info) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return DASP_E_OPEN;
  WavInfo w;
  int rc = parse_header(f, &w);
  if (rc != 0) { std::fclose(f); return rc; }
  if (!format_supported(w)) { std::fclose(f); return DASP_E_UNSUPP; }
  if (out_info) *out_info = w;
  if (take_ch <= 0 || take_ch > w.channels) take_ch = w.channels;
  if (offset < 0 || frames < 0) { std::fclose(f); return DASP_E_RANGE; }
  int64_t avail = w.num_frames > offset ? w.num_frames - offset : 0;
  int64_t n = frames < avail ? frames : avail;
  std::memset(out, 0, sizeof(float) * (size_t)take_ch * (size_t)frames);
  if (n > 0) {
    const int64_t stride = (int64_t)w.channels * (w.bits / 8);
    if (std::fseek(f, (long)(w.data_offset + offset * stride), SEEK_SET) != 0) {
      std::fclose(f);
      return DASP_E_IO;
    }
    std::vector<unsigned char> raw((size_t)(n * stride));
    if (std::fread(raw.data(), 1, raw.size(), f) != raw.size()) {
      std::fclose(f);
      return DASP_E_IO;
    }
    // deinterleave into a dense (take_ch, n) block, then scatter rows
    // into the (take_ch, frames) zero-padded output
    if (n == frames) {
      convert(raw.data(), w, n, take_ch, out);
    } else {
      std::vector<float> tmp((size_t)take_ch * (size_t)n);
      convert(raw.data(), w, n, take_ch, tmp.data());
      for (int c = 0; c < take_ch; c++)
        std::memcpy(out + (int64_t)c * frames, tmp.data() + (int64_t)c * n,
                    sizeof(float) * (size_t)n);
    }
  }
  std::fclose(f);
  return n;
}

} // namespace

extern "C" {

const char* dasp_strerror(int code) {
  switch (code) {
    case DASP_E_OPEN: return "cannot open file";
    case DASP_E_FORMAT: return "not a parseable RIFF/WAVE file";
    case DASP_E_UNSUPP: return "unsupported WAV sample format";
    case DASP_E_RANGE: return "read range outside data chunk";
    case DASP_E_IO: return "short read or write failure";
    case DASP_E_ARG: return "bad argument";
    default: return "ok";
  }
}

int dasp_abi_version(void) { return 1; }

// Header-only probe. Returns 0 or DASP_E_*.
int dasp_wav_info(const char* path, int32_t* sample_rate, int32_t* channels,
                  int64_t* num_frames, int32_t* bits, int32_t* is_float) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return DASP_E_OPEN;
  WavInfo w;
  int rc = parse_header(f, &w);
  std::fclose(f);
  if (rc != 0) return rc;
  if (!format_supported(w)) return DASP_E_UNSUPP;
  if (sample_rate) *sample_rate = (int32_t)w.sample_rate;
  if (channels) *channels = w.channels;
  if (num_frames) *num_frames = w.num_frames;
  if (bits) *bits = w.bits;
  if (is_float) *is_float = w.format == 3 ? 1 : 0;
  return 0;
}

// Decode frames [offset, offset+frames) of the first `out_channels`
// channels into out (float32, deinterleaved (out_channels, frames), tail
// zero-filled). out_channels<=0 means "all channels" (caller sized out
// from dasp_wav_info). Returns frames decoded or DASP_E_*.
int64_t dasp_wav_read(const char* path, float* out, int64_t offset,
                      int64_t frames, int32_t out_channels) {
  if (!path || !out) return DASP_E_ARG;
  return read_range(path, offset, frames, out_channels, out, nullptr);
}

// Write deinterleaved float32 (channels, frames) as 16-bit PCM with
// saturating clip to [-1, 1]. Returns 0 or DASP_E_*.
int dasp_wav_write(const char* path, const float* audio, int32_t channels,
                   int64_t frames, int32_t sample_rate) {
  if (!path || !audio || channels <= 0 || frames < 0) return DASP_E_ARG;
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return DASP_E_OPEN;
  int64_t data_bytes = frames * channels * 2;
  unsigned char hdr[44];
  auto wr_u32 = [&](int off, uint32_t v) {
    hdr[off] = v & 0xFF; hdr[off + 1] = (v >> 8) & 0xFF;
    hdr[off + 2] = (v >> 16) & 0xFF; hdr[off + 3] = (v >> 24) & 0xFF;
  };
  auto wr_u16 = [&](int off, uint16_t v) {
    hdr[off] = v & 0xFF; hdr[off + 1] = (v >> 8) & 0xFF;
  };
  std::memcpy(hdr, "RIFF", 4);
  wr_u32(4, (uint32_t)(36 + data_bytes));
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  wr_u32(16, 16);
  wr_u16(20, 1);
  wr_u16(22, (uint16_t)channels);
  wr_u32(24, (uint32_t)sample_rate);
  wr_u32(28, (uint32_t)(sample_rate * channels * 2));
  wr_u16(32, (uint16_t)(channels * 2));
  wr_u16(34, 16);
  std::memcpy(hdr + 36, "data", 4);
  wr_u32(40, (uint32_t)data_bytes);
  if (std::fwrite(hdr, 1, 44, f) != 44) { std::fclose(f); return DASP_E_IO; }
  std::vector<int16_t> row((size_t)(channels * 4096));
  for (int64_t t0 = 0; t0 < frames; t0 += 4096) {
    int64_t n = frames - t0 < 4096 ? frames - t0 : 4096;
    for (int64_t t = 0; t < n; t++) // interleave
      for (int c = 0; c < channels; c++) {
        float v = audio[(int64_t)c * frames + t0 + t];
        v = v > 1.0f ? 1.0f : (v < -1.0f ? -1.0f : v);
        row[(size_t)(t * channels + c)] = (int16_t)(v * 32767.0f);
      }
    if (std::fwrite(row.data(), 2, (size_t)(n * channels), f) !=
        (size_t)(n * channels)) {
      std::fclose(f);
      return DASP_E_IO;
    }
  }
  std::fclose(f);
  return 0;
}

// Thread-pool batch loader: clip i = frames [offsets[i], offsets[i]+frames)
// of paths[i], mono-mixed (mean over source channels) when mono_mix, else
// first `channels` channels. Fills out (batch, channels, frames) float32
// contiguous. Returns 0 or the first DASP_E_* any worker hit.
int dasp_load_batch(const char** paths, const int64_t* offsets, int32_t batch,
                    int64_t frames, int32_t channels, int32_t mono_mix,
                    float* out, int32_t num_threads) {
  if (!paths || !offsets || !out || batch < 0 || frames <= 0 || channels <= 0)
    return DASP_E_ARG;
  if (num_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    num_threads = hc ? (int32_t)hc : 1;
  }
  if (num_threads > batch) num_threads = batch > 0 ? batch : 1;
  std::atomic<int32_t> next(0);
  std::atomic<int> err(0);
  auto work = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= batch) return;
      float* dst = out + (int64_t)i * channels * frames;
      if (mono_mix) {
        int32_t sr, ch, bits, isf;
        int64_t nf;
        int rc = dasp_wav_info(paths[i], &sr, &ch, &nf, &bits, &isf);
        if (rc != 0) { int z = 0; err.compare_exchange_strong(z, rc); continue; }
        std::vector<float> all((size_t)ch * (size_t)frames);
        int64_t n = read_range(paths[i], offsets[i], frames, ch, all.data(), nullptr);
        if (n < 0) { int z = 0; err.compare_exchange_strong(z, (int)n); continue; }
        const float inv = 1.0f / (float)ch;
        for (int64_t t = 0; t < frames; t++) {
          float acc = 0.0f;
          for (int c = 0; c < ch; c++) acc += all[(size_t)c * frames + t];
          dst[t] = acc * inv;
        }
        for (int c = 1; c < channels; c++) // duplicate mono to extra outs
          std::memcpy(dst + (int64_t)c * frames, dst, sizeof(float) * (size_t)frames);
      } else {
        int32_t sr, ch, bits, isf;
        int64_t nf;
        int rc = dasp_wav_info(paths[i], &sr, &ch, &nf, &bits, &isf);
        if (rc != 0) { int z = 0; err.compare_exchange_strong(z, rc); continue; }
        int64_t n = read_range(paths[i], offsets[i], frames, channels, dst, nullptr);
        if (n < 0) { int z = 0; err.compare_exchange_strong(z, (int)n); continue; }
        // file has fewer channels than requested: read_range clamps to
        // the file's count, so silence the remaining output rows (the
        // caller's buffer is uninitialized)
        for (int c = ch; c < channels; c++)
          std::memset(dst + (int64_t)c * frames, 0, sizeof(float) * (size_t)frames);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < num_threads; t++) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return err.load();
}

// Per-chunk absolute peak (max |sample| over ALL channels, matching the
// Python indexer's np.abs(chunk).max()) over non-overlapping chunk_frames
// windows, streaming the file once — the silence-skipping indexer
// (ref style_transfer.py:159-213) without a whole-file Python decode.
// Writes min(num_chunks, max_chunks) peaks; returns chunk count or DASP_E_*.
int64_t dasp_chunk_peaks(const char* path, int64_t chunk_frames,
                         float* out_peaks, int64_t max_chunks) {
  if (!path || !out_peaks || chunk_frames <= 0 || max_chunks < 0)
    return DASP_E_ARG;
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return DASP_E_OPEN;
  WavInfo w;
  int rc = parse_header(f, &w);
  if (rc != 0) { std::fclose(f); return rc; }
  if (!format_supported(w)) { std::fclose(f); return DASP_E_UNSUPP; }
  int64_t num_chunks = w.num_frames / chunk_frames;  // full chunks only
  if (num_chunks > max_chunks) num_chunks = max_chunks;
  const int64_t stride = (int64_t)w.channels * (w.bits / 8);
  if (std::fseek(f, (long)w.data_offset, SEEK_SET) != 0) {
    std::fclose(f);
    return DASP_E_IO;
  }
  std::vector<unsigned char> raw((size_t)(chunk_frames * stride));
  std::vector<float> buf((size_t)w.channels * (size_t)chunk_frames);
  const size_t total = (size_t)w.channels * (size_t)chunk_frames;
  for (int64_t k = 0; k < num_chunks; k++) {
    if (std::fread(raw.data(), 1, raw.size(), f) != raw.size()) {
      std::fclose(f);
      return DASP_E_IO;
    }
    convert(raw.data(), w, chunk_frames, w.channels, buf.data());
    float peak = 0.0f;
    for (size_t t = 0; t < total; t++) {
      float a = buf[t] < 0 ? -buf[t] : buf[t];
      if (a > peak) peak = a;
    }
    out_peaks[k] = peak;
  }
  std::fclose(f);
  return num_chunks;
}

} // extern "C"
