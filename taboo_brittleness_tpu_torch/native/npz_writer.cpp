// Parallel compressed .npz writer.
//
// The parity-dump path writes the reference-schema all_probs tensor
// ([L, T, V] f32, GB-scale per prompt; reference src/run_generation.py:57),
// which np.savez_compressed deflates on one thread.  This writer produces
// byte-compatible npz files (a ZIP archive of .npy members,
// deflate-compressed) but compresses each member in N-thread chunks,
// pigz-style:
//
//   - split the raw bytes into chunks, deflate each independently with raw
//     deflate (windowBits=-15); every chunk but the last ends with
//     Z_SYNC_FLUSH (byte-aligned, no stream end), the last with Z_FINISH —
//     the concatenation is one valid deflate stream;
//   - per-chunk CRC32s combine with crc32_combine;
//   - the ZIP container (local headers, central directory, zip64 for >4 GB
//     members) is written sequentially.
//
// The source, the C ABI and the chunk plan are the JAX package's writer
// (taboo_brittleness_tpu/native/npz_writer.cpp), so the two packages write
// byte-equal files from the same arrays, zlib and thread count.  Exposed as a
// C ABI for ctypes (taboo_brittleness_tpu_torch/runtime/native_io.py).  No
// Python/numpy headers needed: the caller passes raw pointers and
// pre-rendered .npy headers.
//
// Build (native_io.build_library does this at first use, into csrc/build/):
//   g++ -O3 -shared -fPIC -pthread -o libnpz_writer.so npz_writer.cpp -lz

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  std::vector<unsigned char> out;
  uLong crc = 0;
  uLong in_len = 0;
  int err = Z_OK;
};

void deflate_chunk(const unsigned char* data, size_t len, bool last, int level,
                   Chunk* chunk) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // Raw deflate: the zip container carries its own framing.
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK) {
    chunk->err = Z_STREAM_ERROR;
    return;
  }
  // zlib's avail_in/avail_out/crc32 lengths are uInt (32-bit): a chunk > 4 GiB
  // fed in one call would silently truncate both the stream and the CRC.
  // Stream the input in bounded slices and drain through a staging buffer.
  constexpr size_t kSlice = static_cast<size_t>(1) << 28;  // 256 MiB << 4 GiB
  std::vector<unsigned char> stage(static_cast<size_t>(1) << 22);
  uLong crc = crc32(0L, Z_NULL, 0);
  size_t pos = 0;
  int rc = Z_OK;
  do {
    size_t take = (len - pos < kSlice) ? len - pos : kSlice;
    bool final_slice = (pos + take == len);
    int flush = final_slice ? (last ? Z_FINISH : Z_SYNC_FLUSH) : Z_NO_FLUSH;
    zs.next_in = const_cast<unsigned char*>(data + pos);
    zs.avail_in = static_cast<uInt>(take);
    if (take) crc = crc32(crc, data + pos, static_cast<uInt>(take));
    do {
      zs.next_out = stage.data();
      zs.avail_out = static_cast<uInt>(stage.size());
      rc = deflate(&zs, flush);
      if (rc == Z_STREAM_ERROR) {
        chunk->err = rc;
        deflateEnd(&zs);
        return;
      }
      chunk->out.insert(chunk->out.end(), stage.data(),
                        stage.data() + (stage.size() - zs.avail_out));
    } while (zs.avail_out == 0 || zs.avail_in > 0 ||
             (flush == Z_FINISH && rc != Z_STREAM_END));
    pos += take;
  } while (pos < len);
  if (last && rc != Z_STREAM_END) {
    chunk->err = Z_STREAM_ERROR;
    deflateEnd(&zs);
    return;
  }
  deflateEnd(&zs);
  chunk->crc = crc;
  chunk->in_len = len;
}

void put_u16(std::string* s, uint16_t v) {
  s->push_back(static_cast<char>(v & 0xff));
  s->push_back(static_cast<char>((v >> 8) & 0xff));
}
void put_u32(std::string* s, uint32_t v) {
  put_u16(s, static_cast<uint16_t>(v & 0xffff));
  put_u16(s, static_cast<uint16_t>((v >> 16) & 0xffff));
}
void put_u64(std::string* s, uint64_t v) {
  put_u32(s, static_cast<uint32_t>(v & 0xffffffffu));
  put_u32(s, static_cast<uint32_t>(v >> 32));
}

struct Member {
  std::string name;       // e.g. "all_probs.npy"
  uint64_t comp_size;
  uint64_t uncomp_size;
  uint32_t crc;
  uint64_t local_offset;
};

constexpr uint32_t kZip64Threshold = 0xfffffffeu;

}  // namespace

extern "C" {

// Incremental writer handle.
struct NpzWriter {
  FILE* f = nullptr;
  std::vector<Member> members;
  int n_threads;
  int level;
};

NpzWriter* npz_open(const char* path, int n_threads, int level) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new NpzWriter();
  w->f = f;
  w->n_threads = n_threads > 0 ? n_threads
                               : static_cast<int>(std::thread::hardware_concurrency());
  if (w->n_threads < 1) w->n_threads = 1;
  w->level = level;
  return w;
}

// Add one member: `name` (no .npy suffix), pre-rendered .npy `header` bytes,
// then `data` of `data_len` bytes.  Returns 0 on success.
int npz_add(NpzWriter* w, const char* name, const unsigned char* header,
            uint64_t header_len, const unsigned char* data, uint64_t data_len) {
  if (!w || !w->f) return -1;
  // Assemble the full uncompressed member (.npy header + payload) chunk plan.
  uint64_t total = header_len + data_len;
  int n = w->n_threads;
  uint64_t min_chunk = 1 << 20;  // 1 MiB floor: tiny members use one thread
  uint64_t chunk_size = total / n;
  if (chunk_size < min_chunk) {
    chunk_size = min_chunk;
    n = static_cast<int>((total + chunk_size - 1) / chunk_size);
    if (n < 1) n = 1;
  }

  // Materialize the member contiguously only when the header splits a chunk;
  // simpler: treat header as chunk 0's prefix.  Copy only chunk 0.
  std::vector<Chunk> chunks(n);
  std::vector<std::thread> threads;
  std::vector<unsigned char> first;
  for (int i = 0; i < n; ++i) {
    uint64_t begin = static_cast<uint64_t>(i) * chunk_size;
    uint64_t end = (i == n - 1) ? total : begin + chunk_size;
    if (end > total) end = total;
    bool last = (i == n - 1);
    if (i == 0) {
      first.assign(header, header + header_len);
      uint64_t data_take = end > header_len ? end - header_len : 0;
      first.insert(first.end(), data, data + data_take);
      threads.emplace_back(deflate_chunk, first.data(), first.size(), last,
                           w->level, &chunks[0]);
    } else {
      const unsigned char* p = data + (begin - header_len);
      threads.emplace_back(deflate_chunk, p, end - begin, last, w->level,
                           &chunks[i]);
    }
  }
  for (auto& t : threads) t.join();

  uint64_t comp_size = 0;
  uLong crc = 0;
  uint64_t seen = 0;
  for (int i = 0; i < n; ++i) {
    if (chunks[i].err != Z_OK) return -2;
    comp_size += chunks[i].out.size();
    crc = seen ? crc32_combine(crc, chunks[i].crc,
                               static_cast<z_off_t>(chunks[i].in_len))
               : chunks[i].crc;
    seen += chunks[i].in_len;
  }
  if (seen != total) return -3;

  Member m;
  m.name = std::string(name) + ".npy";
  m.comp_size = comp_size;
  m.uncomp_size = total;
  m.crc = static_cast<uint32_t>(crc);
  m.local_offset = static_cast<uint64_t>(std::ftell(w->f));

  bool zip64 = total >= kZip64Threshold || comp_size >= kZip64Threshold;
  std::string hdr;
  put_u32(&hdr, 0x04034b50);                  // local file header
  put_u16(&hdr, zip64 ? 45 : 20);             // version needed
  put_u16(&hdr, 0);                           // flags
  put_u16(&hdr, 8);                           // deflate
  put_u16(&hdr, 0);                           // mod time
  put_u16(&hdr, 0x21);                        // mod date (numpy uses 1980-1-1)
  put_u32(&hdr, m.crc);
  put_u32(&hdr, zip64 ? 0xffffffffu : static_cast<uint32_t>(comp_size));
  put_u32(&hdr, zip64 ? 0xffffffffu : static_cast<uint32_t>(total));
  put_u16(&hdr, static_cast<uint16_t>(m.name.size()));
  put_u16(&hdr, zip64 ? 20 : 0);              // extra length
  hdr += m.name;
  if (zip64) {
    put_u16(&hdr, 0x0001);                     // zip64 extra
    put_u16(&hdr, 16);
    put_u64(&hdr, total);
    put_u64(&hdr, comp_size);
  }
  if (std::fwrite(hdr.data(), 1, hdr.size(), w->f) != hdr.size()) return -4;
  for (int i = 0; i < n; ++i) {
    if (std::fwrite(chunks[i].out.data(), 1, chunks[i].out.size(), w->f) !=
        chunks[i].out.size())
      return -4;
  }
  w->members.push_back(std::move(m));
  return 0;
}

int npz_close(NpzWriter* w) {
  if (!w) return -1;
  int rc = 0;
  if (w->f) {
    uint64_t cd_start = static_cast<uint64_t>(std::ftell(w->f));
    std::string cd;
    for (const auto& m : w->members) {
      bool zip64 = m.uncomp_size >= kZip64Threshold ||
                   m.comp_size >= kZip64Threshold ||
                   m.local_offset >= kZip64Threshold;
      put_u32(&cd, 0x02014b50);
      put_u16(&cd, zip64 ? 45 : 20);          // version made by
      put_u16(&cd, zip64 ? 45 : 20);          // version needed
      put_u16(&cd, 0);
      put_u16(&cd, 8);
      put_u16(&cd, 0);
      put_u16(&cd, 0x21);
      put_u32(&cd, m.crc);
      put_u32(&cd, zip64 ? 0xffffffffu : static_cast<uint32_t>(m.comp_size));
      put_u32(&cd, zip64 ? 0xffffffffu : static_cast<uint32_t>(m.uncomp_size));
      put_u16(&cd, static_cast<uint16_t>(m.name.size()));
      put_u16(&cd, zip64 ? 28 : 0);
      put_u16(&cd, 0);                        // comment
      put_u16(&cd, 0);                        // disk
      put_u16(&cd, 0);                        // internal attrs
      put_u32(&cd, 0);                        // external attrs
      put_u32(&cd, zip64 ? 0xffffffffu
                         : static_cast<uint32_t>(m.local_offset));
      cd += m.name;
      if (zip64) {
        put_u16(&cd, 0x0001);
        put_u16(&cd, 24);
        put_u64(&cd, m.uncomp_size);
        put_u64(&cd, m.comp_size);
        put_u64(&cd, m.local_offset);
      }
    }
    uint64_t cd_size = cd.size();
    uint64_t n_members = w->members.size();
    bool need64 = cd_start >= kZip64Threshold || n_members >= 0xffff;
    if (std::fwrite(cd.data(), 1, cd.size(), w->f) != cd.size()) rc = -4;
    std::string eocd;
    if (need64) {
      uint64_t z64_off = cd_start + cd_size;
      put_u32(&eocd, 0x06064b50);              // zip64 EOCD
      put_u64(&eocd, 44);
      put_u16(&eocd, 45);
      put_u16(&eocd, 45);
      put_u32(&eocd, 0);
      put_u32(&eocd, 0);
      put_u64(&eocd, n_members);
      put_u64(&eocd, n_members);
      put_u64(&eocd, cd_size);
      put_u64(&eocd, cd_start);
      put_u32(&eocd, 0x07064b50);              // zip64 EOCD locator
      put_u32(&eocd, 0);
      put_u64(&eocd, z64_off);
      put_u32(&eocd, 1);
    }
    put_u32(&eocd, 0x06054b50);                // EOCD
    put_u16(&eocd, 0);
    put_u16(&eocd, 0);
    put_u16(&eocd, static_cast<uint16_t>(
        n_members >= 0xffff ? 0xffff : n_members));
    put_u16(&eocd, static_cast<uint16_t>(
        n_members >= 0xffff ? 0xffff : n_members));
    put_u32(&eocd, cd_size >= kZip64Threshold ? 0xffffffffu
                                              : static_cast<uint32_t>(cd_size));
    put_u32(&eocd, cd_start >= kZip64Threshold
                       ? 0xffffffffu
                       : static_cast<uint32_t>(cd_start));
    put_u16(&eocd, 0);
    if (std::fwrite(eocd.data(), 1, eocd.size(), w->f) != eocd.size()) rc = -4;
    if (std::fclose(w->f) != 0) rc = -5;
  }
  delete w;
  return rc;
}

}  // extern "C"
