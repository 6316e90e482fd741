// Native npz dataset loader.
//
// The training/eval data layer reads .npz feature datasets (zip archives of
// .npy members — the format the reference loads with np.load,
// Model-96/utilities.py:31-34).  This loader parses the zip central directory
// and npy headers directly and inflates DEFLATE members with zlib, giving the
// Python side a zero-copy-into-numpy fast path (see headpose_tpu_torch/data/native.py)
// that also serves as the framework's native-runtime data plane.
//
// Build: g++ -O3 -shared -fPIC -o libnpzloader.so npz_loader.cpp -lz
//
// C API (ctypes-friendly):
//   void*  npz_open(const char* path)
//   int    npz_num_entries(void* h)
//   const char* npz_entry_name(void* h, int i)       // e.g. "features.npy"
//   int    npz_entry_info(void* h, int i, char* dtype /*16B*/, long* shape,
//                         int* ndim /*in: capacity, out: rank*/)
//   long   npz_entry_bytes(void* h, int i)
//   int    npz_read(void* h, int i, void* dst)       // 0 on success
//   const char* npz_last_error(void* h)
//   void   npz_close(void* h)

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Entry {
  std::string name;        // member name inside the archive
  std::string dtype;       // numpy descr, e.g. "<f4"
  std::vector<long> shape;
  bool fortran = false;
  uint64_t data_offset = 0;   // file offset of the member payload
  uint64_t comp_size = 0;     // payload bytes in the archive
  uint64_t raw_size = 0;      // uncompressed member bytes (npy file size)
  uint64_t array_bytes = 0;   // payload bytes of the array itself
  uint64_t header_bytes = 0;  // npy header bytes to skip
  uint16_t method = 0;        // 0 = stored, 8 = deflate
};

struct Archive {
  FILE* f = nullptr;
  std::vector<Entry> entries;
  std::string error;
};

uint16_t rd16(const unsigned char* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

bool read_at(FILE* f, uint64_t off, void* dst, size_t n) {
  if (fseeko(f, off, SEEK_SET) != 0) return false;
  return fread(dst, 1, n, f) == n;
}

// Parse "{'descr': '<f4', 'fortran_order': False, 'shape': (10284, 88), }"
bool parse_npy_header(const std::string& hdr, Entry* e) {
  auto find_val = [&](const char* key) -> std::string {
    size_t k = hdr.find(key);
    if (k == std::string::npos) return "";
    size_t c = hdr.find(':', k);
    if (c == std::string::npos) return "";
    size_t end = c + 1;
    int depth = 0;
    while (end < hdr.size()) {
      char ch = hdr[end];
      if (ch == '(') depth++;
      if (ch == ')') { if (depth == 0) break; depth--; if (depth == 0) { end++; break; } }
      if ((ch == ',' || ch == '}') && depth == 0) break;
      end++;
    }
    return hdr.substr(c + 1, end - c - 1);
  };
  std::string descr = find_val("'descr'");
  size_t q1 = descr.find('\'');
  size_t q2 = descr.rfind('\'');
  if (q1 == std::string::npos || q2 <= q1) return false;
  e->dtype = descr.substr(q1 + 1, q2 - q1 - 1);
  e->fortran = find_val("'fortran_order'").find("True") != std::string::npos;
  std::string shape = find_val("'shape'");
  e->shape.clear();
  long cur = -1;
  for (char ch : shape) {
    if (ch >= '0' && ch <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (ch - '0');
    } else if (cur >= 0) {
      e->shape.push_back(cur);
      cur = -1;
    }
  }
  if (cur >= 0) e->shape.push_back(cur);
  return true;
}

int itemsize(const std::string& dtype) {
  // trailing digits of the descr, e.g. "<f4" → 4, "<f8" → 8, "|u1" → 1
  int n = 0;
  for (char ch : dtype)
    if (ch >= '0' && ch <= '9') n = n * 10 + (ch - '0');
  return n ? n : 1;
}

bool inflate_member(FILE* f, const Entry& e, std::vector<unsigned char>* out,
                    uint64_t max_bytes = 0) {
  // max_bytes > 0: decompress only a prefix (cheap npy-header peek)
  uint64_t want = max_bytes ? std::min(max_bytes, e.raw_size) : e.raw_size;
  out->resize(want);
  if (e.method == 0) {
    return read_at(f, e.data_offset, out->data(), want);
  }
  std::vector<unsigned char> comp;
  uint64_t comp_take = e.comp_size;
  if (max_bytes) {
    // a deflate prefix of ~2x the wanted output is always enough for npy
    // headers (they are ASCII, compression ratio < 2x)
    comp_take = std::min<uint64_t>(e.comp_size, max_bytes * 2 + 256);
  }
  comp.resize(comp_take);
  if (!read_at(f, e.data_offset, comp.data(), comp_take)) return false;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;  // raw deflate
  zs.next_in = comp.data();
  zs.avail_in = static_cast<uInt>(comp.size());
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(out->size());
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (max_bytes) return rc == Z_STREAM_END || rc == Z_OK || rc == Z_BUF_ERROR;
  return rc == Z_STREAM_END;
}

bool load_central_directory(Archive* a) {
  FILE* f = a->f;
  if (fseeko(f, 0, SEEK_END) != 0) return false;
  uint64_t fsize = ftello(f);
  // find EOCD (scan the last 64KB + 22 for the signature)
  size_t scan = fsize < 65558 ? fsize : 65558;
  std::vector<unsigned char> tail(scan);
  if (!read_at(f, fsize - scan, tail.data(), scan)) return false;
  long eocd = -1;
  for (long i = static_cast<long>(scan) - 22; i >= 0; i--) {
    if (rd32(&tail[i]) == 0x06054b50) { eocd = i; break; }
  }
  if (eocd < 0) { a->error = "no zip end-of-central-directory"; return false; }
  uint16_t count = rd16(&tail[eocd + 10]);
  uint32_t cd_off = rd32(&tail[eocd + 16]);

  uint64_t pos = cd_off;
  for (int i = 0; i < count; i++) {
    unsigned char ch[46];
    if (!read_at(f, pos, ch, 46) || rd32(ch) != 0x02014b50) {
      a->error = "bad central directory entry";
      return false;
    }
    Entry e;
    e.method = rd16(ch + 10);
    e.comp_size = rd32(ch + 20);
    e.raw_size = rd32(ch + 24);
    uint16_t nlen = rd16(ch + 28), xlen = rd16(ch + 30), clen = rd16(ch + 32);
    uint32_t lho = rd32(ch + 42);
    std::vector<char> name(nlen);
    if (!read_at(f, pos + 46, name.data(), nlen)) return false;
    e.name.assign(name.data(), nlen);
    pos += 46 + nlen + xlen + clen;

    // local header gives the payload offset
    unsigned char lh[30];
    if (!read_at(f, lho, lh, 30) || rd32(lh) != 0x04034b50) {
      a->error = "bad local header";
      return false;
    }
    e.data_offset = lho + 30 + rd16(lh + 26) + rd16(lh + 28);

    // npy header: magic(6) ver(2) hlen(2 or 4) header — peek a 1KB prefix
    std::vector<unsigned char> head;
    if (!inflate_member(f, e, &head, 1024)) {
      a->error = "header inflate failed";
      return false;
    }
    if (head.size() < 10 || std::memcmp(head.data(), "\x93NUMPY", 6) != 0) {
      a->error = "member is not npy: " + e.name;
      return false;
    }
    int major = head[6];
    uint64_t hlen, hstart;
    if (major == 1) { hlen = rd16(&head[8]); hstart = 10; }
    else { hlen = rd32(&head[8]); hstart = 12; }
    std::string hdr(reinterpret_cast<char*>(&head[hstart]),
                    std::min<uint64_t>(hlen, head.size() - hstart));
    if (!parse_npy_header(hdr, &e)) { a->error = "bad npy header"; return false; }
    e.header_bytes = hstart + hlen;
    // npz_read memcpys array_bytes into a caller buffer sized from
    // shape x itemsize — validate they agree HERE so a malformed/truncated
    // archive (or a zip64 size marker) becomes a clean open error instead
    // of a heap overflow
    if (e.raw_size == 0xFFFFFFFFull || e.comp_size == 0xFFFFFFFFull) {
      a->error = "zip64 member not supported: " + e.name;
      return false;
    }
    if (e.raw_size < e.header_bytes) {
      a->error = "truncated npy member: " + e.name;
      return false;
    }
    e.array_bytes = e.raw_size - e.header_bytes;
    uint64_t expect = static_cast<uint64_t>(itemsize(e.dtype));
    for (long d : e.shape) {
      if (d < 0) { a->error = "bad npy shape: " + e.name; return false; }
      expect *= static_cast<uint64_t>(d);
    }
    if (e.array_bytes != expect) {
      a->error = "npy payload size mismatch: " + e.name;
      return false;
    }
    a->entries.push_back(std::move(e));
  }
  return true;
}

}  // namespace

extern "C" {

void* npz_open(const char* path) {
  Archive* a = new Archive();
  a->f = fopen(path, "rb");
  if (!a->f) { delete a; return nullptr; }
  if (!load_central_directory(a)) {
    // keep handle so the caller can read the error? simpler: fail hard
    fclose(a->f);
    delete a;
    return nullptr;
  }
  return a;
}

int npz_num_entries(void* h) {
  return static_cast<int>(static_cast<Archive*>(h)->entries.size());
}

const char* npz_entry_name(void* h, int i) {
  return static_cast<Archive*>(h)->entries[i].name.c_str();
}

int npz_entry_info(void* h, int i, char* dtype, long* shape, int* ndim) {
  const Entry& e = static_cast<Archive*>(h)->entries[i];
  std::snprintf(dtype, 16, "%s", e.dtype.c_str());
  int cap = *ndim;
  *ndim = static_cast<int>(e.shape.size());
  for (int d = 0; d < *ndim && d < cap; d++) shape[d] = e.shape[d];
  return 0;
}

long npz_entry_bytes(void* h, int i) {
  return static_cast<long>(static_cast<Archive*>(h)->entries[i].array_bytes);
}

int npz_entry_fortran(void* h, int i) {
  return static_cast<Archive*>(h)->entries[i].fortran ? 1 : 0;
}

int npz_read(void* h, int i, void* dst) {
  Archive* a = static_cast<Archive*>(h);
  const Entry& e = a->entries[i];
  std::vector<unsigned char> buf;
  if (!inflate_member(a->f, e, &buf)) {
    a->error = "read failed: " + e.name;
    return 1;
  }
  std::memcpy(dst, buf.data() + e.header_bytes, e.array_bytes);
  return 0;
}

const char* npz_last_error(void* h) {
  return static_cast<Archive*>(h)->error.c_str();
}

void npz_close(void* h) {
  Archive* a = static_cast<Archive*>(h);
  if (a->f) fclose(a->f);
  delete a;
}

}  // extern "C"
