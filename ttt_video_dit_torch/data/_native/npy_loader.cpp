// Native prefetching .npy/.npz reader for the data pipeline.
//
// The reference's loader is a torch Dataset + DataLoader with Python worker
// processes (reference: ttt/datasets/preembedding_dataset.py:82-91,
// train.py:127 num_workers=2); the TPU rebuild's default is a Python thread
// prefetcher (data/dataset.py DataModule.batches). This module is the
// optional native fast path: a C++ thread pool that parses .npy headers and
// preads file contents into malloc'd buffers off the GIL, so host-side
// decode never stalls the device feed even with many concurrent shards.
//
// Exposed as a tiny C API consumed via ctypes (no pybind11 in the image).
// Supported payloads: little-endian f2/f4/f8, i1/i2/i4/i8, u1, C-order,
// .npy format versions 1.x/2.x — either bare or as the FIRST .npy member of
// a .npz zip container (stored or deflate; matches np.load(...)[first key]).
// Deflated members stream through zlib straight into the result buffer, so
// peak memory is payload + one 64 KB window, never 2x the array.
//
// Torch `.pt` containers (the reference's precomputed-latent format,
// reference: data/precomp_video.py torch.save) are also read natively: the
// zip member `*/data.pkl` is run through a minimal protocol-2 pickle VM
// that accepts exactly the shape torch.save emits for ONE plain CPU tensor
// (torch._utils._rebuild_tensor_v2 over a persistent storage id), then the
// `*/data/<key>` member supplies the payload. Arbitrary strides and storage
// offsets are gathered into a C-order result; BFloat16Storage widens to f4
// (numpy has no bf16 — torch.load().float() agrees bit-exactly). Anything
// else (sparse/quantized tensors, legacy non-zip .pt) returns an
// error and the Python caller falls back to torch.load.
//
// Dict-of-tensor .pt files (the reference's VAE checkpoint format:
// torch.save({'state_dict': OrderedDict(name -> tensor)})) are served via
// the nl_pt_dict_* handle API: the pickle VM retains dict contents, nested
// dicts flatten with dotted prefixes, and each named tensor materializes
// lazily from its storage member on nl_pt_dict_get.

#include <malloc.h>
#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Result {
  void* data = nullptr;
  int64_t shape[8] = {0};
  int32_t ndim = 0;
  int32_t dtype = -1;  // 0:f4 1:f2 2:f8 3:i1 4:i2 5:i4 6:i8 7:u1
  int32_t status = -1; // 0 ok, <0 error code
};

int dtype_code(const std::string& descr) {
  // descr like "<f4", "|u1", "<i8"; big-endian unsupported.
  if (descr.size() < 3) return -1;
  char bo = descr[0];
  if (bo != '<' && bo != '|' && bo != '=') return -1;
  const std::string t = descr.substr(1);
  if (t == "f4") return 0;
  if (t == "f2") return 1;
  if (t == "f8") return 2;
  if (t == "i1") return 3;
  if (t == "i2") return 4;
  if (t == "i4") return 5;
  if (t == "i8") return 6;
  if (t == "u1") return 7;
  return -1;
}

size_t dtype_size(int code) {
  static const size_t sizes[] = {4, 2, 8, 1, 2, 4, 8, 1};
  return (code >= 0 && code < 8) ? sizes[code] : 0;
}

// Parse the python-dict header: {'descr': '<f4', 'fortran_order': False,
// 'shape': (3, 4), }
int parse_header(const std::string& hdr, Result* r) {
  auto find_val = [&](const char* key) -> std::string {
    size_t p = hdr.find(key);
    if (p == std::string::npos) return "";
    p = hdr.find(':', p);
    if (p == std::string::npos) return "";
    ++p;
    while (p < hdr.size() && (hdr[p] == ' ')) ++p;
    return hdr.substr(p);
  };

  std::string descr = find_val("'descr'");
  if (descr.empty() || descr[0] != '\'') return -2;
  size_t q = descr.find('\'', 1);
  if (q == std::string::npos) return -2;
  r->dtype = dtype_code(descr.substr(1, q - 1));
  if (r->dtype < 0) return -3;

  std::string forder = find_val("'fortran_order'");
  if (forder.rfind("False", 0) != 0) return -4;  // C-order only

  std::string shape = find_val("'shape'");
  if (shape.empty() || shape[0] != '(') return -5;
  size_t close = shape.find(')');
  if (close == std::string::npos) return -5;
  std::string dims = shape.substr(1, close - 1);
  r->ndim = 0;
  const char* s = dims.c_str();
  char* end = nullptr;
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    long long v = strtoll(s, &end, 10);
    if (end == s) break;
    if (r->ndim >= 8) return -6;
    r->shape[r->ndim++] = (int64_t)v;
    s = end;
  }
  return 0;
}

// Byte source for the .npy parser: a plain file region or a deflate stream.
struct Reader {
  virtual ~Reader() = default;
  virtual bool read(void* dst, size_t n) = 0;  // exactly n bytes or fail
};

struct FileReader : Reader {
  FILE* f;
  size_t remaining;
  FileReader(FILE* file, size_t limit) : f(file), remaining(limit) {}
  bool read(void* dst, size_t n) override {
    if (n > remaining) return false;
    if (fread(dst, 1, n, f) != n) return false;
    remaining -= n;
    return true;
  }
};

struct InflateReader : Reader {
  FILE* f;
  size_t comp_remaining;
  z_stream zs;
  unsigned char inbuf[1 << 16];
  bool ok;
  InflateReader(FILE* file, size_t comp) : f(file), comp_remaining(comp) {
    memset(&zs, 0, sizeof(zs));
    ok = inflateInit2(&zs, -15) == Z_OK;  // raw deflate (zip members)
  }
  ~InflateReader() override {
    if (ok) inflateEnd(&zs);
  }
  bool read(void* dst, size_t n) override {
    if (!ok) return false;
    zs.next_out = (Bytef*)dst;
    zs.avail_out = (uInt)n;
    while (zs.avail_out > 0) {
      if (zs.avail_in == 0) {
        size_t want = comp_remaining < sizeof(inbuf) ? comp_remaining : sizeof(inbuf);
        if (want == 0) return false;  // truncated stream
        size_t got = fread(inbuf, 1, want, f);
        if (got == 0) return false;
        comp_remaining -= got;
        zs.next_in = inbuf;
        zs.avail_in = (uInt)got;
      }
      int rc = inflate(&zs, Z_NO_FLUSH);
      if (rc == Z_STREAM_END) return zs.avail_out == 0;
      if (rc != Z_OK) return false;
    }
    return true;
  }
};

// Parse one .npy stream (header + payload) from `in` into `r`. The payload
// lands directly in the final malloc'd buffer — no staging copy.
int load_npy_stream(Reader& in, Result* r) {
  unsigned char magic[8];
  if (!in.read(magic, 8) || memcmp(magic, "\x93NUMPY", 6) != 0) return -11;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (!in.read(b, 2)) return -12;
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (!in.read(b, 4)) return -12;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
  }
  std::string hdr(hlen, '\0');
  if (hlen && !in.read(&hdr[0], hlen)) return -13;
  int rc = parse_header(hdr, r);
  if (rc != 0) return rc;

  size_t count = 1;
  for (int i = 0; i < r->ndim; ++i) count *= (size_t)r->shape[i];
  size_t nbytes = count * dtype_size(r->dtype);
  r->data = malloc(nbytes ? nbytes : 1);
  if (!r->data) return -14;
  if (nbytes && !in.read(r->data, nbytes)) {
    free(r->data);
    r->data = nullptr;
    return -15;
  }
  return 0;
}

inline uint16_t rd16(const unsigned char* p) { return p[0] | (p[1] << 8); }
inline uint32_t rd32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

struct ZipEntry {
  std::string name;
  int method = 0;          // 0 stored, 8 deflate
  size_t comp_size = 0;
  size_t uncomp_size = 0;
  long local_off = 0;      // local-header offset (payload located lazily)
};

// Scan the central directory into `entries` (np.savez writes members in key
// order; torch.save writes data.pkl + one member per storage). Zip64
// archives (any 0xFFFFFFFF marker) return -31 and the caller falls back to
// Python.
int scan_zip(FILE* f, std::vector<ZipEntry>* entries) {
  if (fseek(f, 0, SEEK_END) != 0) return -30;
  long fsize = ftell(f);
  if (fsize < 22) return -30;
  long tail = fsize < 65557 ? fsize : 65557;  // EOCD + max comment
  std::vector<unsigned char> buf(tail);
  if (fseek(f, fsize - tail, SEEK_SET) != 0) return -30;
  if (fread(buf.data(), 1, (size_t)tail, f) != (size_t)tail) return -30;
  long eocd = -1;
  for (long i = tail - 22; i >= 0; --i) {
    if (buf[i] == 0x50 && buf[i + 1] == 0x4b && buf[i + 2] == 0x05 && buf[i + 3] == 0x06) {
      eocd = i;
      break;
    }
  }
  if (eocd < 0) return -30;
  uint16_t nent = rd16(&buf[eocd + 10]);
  uint32_t cd_size = rd32(&buf[eocd + 12]);
  uint32_t cd_off = rd32(&buf[eocd + 16]);
  if (cd_off == 0xFFFFFFFF || cd_size == 0xFFFFFFFF) return -31;  // zip64

  std::vector<unsigned char> cd(cd_size);
  if (fseek(f, (long)cd_off, SEEK_SET) != 0) return -30;
  if (fread(cd.data(), 1, cd_size, f) != cd_size) return -30;

  size_t p = 0;
  for (int e = 0; e < nent; ++e) {
    if (p + 46 > cd.size() || rd32(&cd[p]) != 0x02014b50) return -32;
    ZipEntry ze;
    ze.method = rd16(&cd[p + 10]);
    uint32_t csize = rd32(&cd[p + 20]);
    uint32_t usize = rd32(&cd[p + 24]);
    uint16_t name_len = rd16(&cd[p + 28]);
    uint16_t extra_len = rd16(&cd[p + 30]);
    uint16_t comment_len = rd16(&cd[p + 32]);
    uint32_t lho = rd32(&cd[p + 42]);
    if (p + 46 + name_len > cd.size()) return -32;
    if (csize == 0xFFFFFFFF || usize == 0xFFFFFFFF || lho == 0xFFFFFFFF) return -31;  // zip64
    ze.name.assign((const char*)&cd[p + 46], name_len);
    ze.comp_size = csize;
    ze.uncomp_size = usize;
    ze.local_off = (long)lho;
    entries->push_back(std::move(ze));
    p += 46 + name_len + extra_len + comment_len;
  }
  return 0;
}

// Position `f` at the entry's payload (past the local header).
int seek_member(FILE* f, const ZipEntry& e) {
  unsigned char lh[30];
  if (fseek(f, e.local_off, SEEK_SET) != 0) return -30;
  if (fread(lh, 1, 30, f) != 30 || rd32(lh) != 0x04034b50) return -35;
  uint16_t nlen = rd16(&lh[26]), elen = rd16(&lh[28]);
  if (fseek(f, e.local_off + 30 + nlen + elen, SEEK_SET) != 0) return -30;
  return 0;
}

// Stream exactly `n` bytes of the (possibly deflated) member into `dst`.
// The member may hold more than `n` bytes (e.g. a storage shared by views);
// trailing bytes are left unread.
int read_member_into(FILE* f, const ZipEntry& e, void* dst, size_t n) {
  if (e.method != 0 && e.method != 8) return -33;
  int rc = seek_member(f, e);
  if (rc != 0) return rc;
  if (e.method == 0) {
    FileReader in(f, e.comp_size);
    return in.read(dst, n) ? 0 : -36;
  }
  InflateReader in(f, e.comp_size);
  return in.read(dst, n) ? 0 : -36;
}

// ---------------------------------------------------------------------------
// Torch .pt: minimal pickle (protocol <=4) VM, just rich enough for the
// stream torch.save emits for one plain CPU tensor. Everything unexpected
// fails loudly (negative rc) and the Python caller falls back to torch.load.
// ---------------------------------------------------------------------------

struct PVal {
  enum T { NONE, BOOL, INT, FLT, STR, TUPLE, LIST, DICT, GLOBAL, OBJ, PERSID } t = NONE;
  int64_t i = 0;
  double d = 0;
  std::string s;            // STR text; GLOBAL/OBJ "module name"
  std::vector<PVal> items;  // TUPLE/LIST elements; OBJ reduce args; PERSID pid tuple
};

struct Unpickler {
  const unsigned char* p;
  size_t n, pos = 0;
  std::vector<PVal> stack;
  std::vector<size_t> marks;
  std::map<uint64_t, PVal> memo;

  bool take(void* dst, size_t k) {
    if (pos + k > n) return false;
    memcpy(dst, p + pos, k);
    pos += k;
    return true;
  }
  bool line(std::string* out) {  // newline-terminated ascii (GLOBAL args)
    size_t e = pos;
    while (e < n && p[e] != '\n') ++e;
    if (e >= n) return false;
    out->assign((const char*)p + pos, e - pos);
    pos = e + 1;
    return true;
  }
  bool pop(PVal* out) {
    if (stack.empty()) return false;
    *out = std::move(stack.back());
    stack.pop_back();
    return true;
  }
  bool pop_mark(std::vector<PVal>* out) {
    if (marks.empty() || stack.size() < marks.back()) return false;
    out->assign(std::make_move_iterator(stack.begin() + marks.back()),
                std::make_move_iterator(stack.end()));
    stack.resize(marks.back());
    marks.pop_back();
    return true;
  }

  // Returns 0 and leaves the unpickled object in *result, else <0.
  int run(PVal* result) {
    while (pos < n) {
      unsigned char op = p[pos++];
      switch (op) {
        case 0x80: {  // PROTO
          unsigned char v;
          if (!take(&v, 1)) return -41;
          break;
        }
        case 0x95: {  // FRAME (proto 4): 8-byte length, informational
          uint64_t len;
          if (!take(&len, 8)) return -41;
          break;
        }
        case '.': {  // STOP
          if (stack.size() != 1) return -41;
          *result = std::move(stack.back());
          return 0;
        }
        case '(':  // MARK
          marks.push_back(stack.size());
          break;
        case 'N':
          stack.emplace_back();
          break;
        case 0x88: case 0x89: {  // NEWTRUE / NEWFALSE
          PVal v; v.t = PVal::BOOL; v.i = (op == 0x88);
          stack.push_back(std::move(v));
          break;
        }
        case 'K': {  // BININT1
          unsigned char b;
          if (!take(&b, 1)) return -41;
          PVal v; v.t = PVal::INT; v.i = b;
          stack.push_back(std::move(v));
          break;
        }
        case 'M': {  // BININT2
          unsigned char b[2];
          if (!take(b, 2)) return -41;
          PVal v; v.t = PVal::INT; v.i = rd16(b);
          stack.push_back(std::move(v));
          break;
        }
        case 'J': {  // BININT (signed 32)
          unsigned char b[4];
          if (!take(b, 4)) return -41;
          PVal v; v.t = PVal::INT; v.i = (int32_t)rd32(b);
          stack.push_back(std::move(v));
          break;
        }
        case 0x8a: {  // LONG1: little-endian two's-complement, k bytes
          unsigned char k;
          if (!take(&k, 1) || k > 8) return -41;
          unsigned char b[8] = {0};
          if (!take(b, k)) return -41;
          int64_t v64 = 0;
          for (int i = (int)k - 1; i >= 0; --i) v64 = (v64 << 8) | b[i];
          if (k > 0 && k < 8 && (b[k - 1] & 0x80)) v64 -= (int64_t)1 << (8 * k);
          PVal v; v.t = PVal::INT; v.i = v64;
          stack.push_back(std::move(v));
          break;
        }
        case 'G': {  // BINFLOAT (big-endian f8)
          unsigned char b[8];
          if (!take(b, 8)) return -41;
          uint64_t u = 0;
          for (int i = 0; i < 8; ++i) u = (u << 8) | b[i];
          PVal v; v.t = PVal::FLT;
          memcpy(&v.d, &u, 8);
          stack.push_back(std::move(v));
          break;
        }
        case 'X': case 'T': case 'B': {  // BINUNICODE / BINSTRING / BINBYTES
          unsigned char b[4];
          if (!take(b, 4)) return -41;
          uint32_t len = rd32(b);
          PVal v; v.t = PVal::STR;
          v.s.resize(len);
          if (len && !take(&v.s[0], len)) return -41;
          stack.push_back(std::move(v));
          break;
        }
        case 0x8c: case 'U': case 'C': {  // SHORT_BINUNICODE / SHORT_BINSTRING / SHORT_BINBYTES
          unsigned char len;
          if (!take(&len, 1)) return -41;
          PVal v; v.t = PVal::STR;
          v.s.resize(len);
          if (len && !take(&v.s[0], len)) return -41;
          stack.push_back(std::move(v));
          break;
        }
        case 'c': {  // GLOBAL: "module\nname\n"
          std::string mod, name;
          if (!line(&mod) || !line(&name)) return -41;
          PVal v; v.t = PVal::GLOBAL; v.s = mod + " " + name;
          stack.push_back(std::move(v));
          break;
        }
        case 0x93: {  // STACK_GLOBAL
          PVal name, mod;
          if (!pop(&name) || !pop(&mod)) return -41;
          if (mod.t != PVal::STR || name.t != PVal::STR) return -41;
          PVal v; v.t = PVal::GLOBAL; v.s = mod.s + " " + name.s;
          stack.push_back(std::move(v));
          break;
        }
        case ')': {  // EMPTY_TUPLE
          PVal v; v.t = PVal::TUPLE;
          stack.push_back(std::move(v));
          break;
        }
        case 0x85: case 0x86: case 0x87: {  // TUPLE1/2/3
          int k = op - 0x85 + 1;
          if ((int)stack.size() < k) return -41;
          PVal v; v.t = PVal::TUPLE;
          v.items.assign(std::make_move_iterator(stack.end() - k),
                         std::make_move_iterator(stack.end()));
          stack.resize(stack.size() - k);
          stack.push_back(std::move(v));
          break;
        }
        case 't': {  // TUPLE (to mark)
          PVal v; v.t = PVal::TUPLE;
          if (!pop_mark(&v.items)) return -41;
          stack.push_back(std::move(v));
          break;
        }
        case ']': {  // EMPTY_LIST
          PVal v; v.t = PVal::LIST;
          stack.push_back(std::move(v));
          break;
        }
        case '}': {  // EMPTY_DICT
          PVal v; v.t = PVal::DICT;
          stack.push_back(std::move(v));
          break;
        }
        case 'a': {  // APPEND
          PVal x;
          if (!pop(&x) || stack.empty() || stack.back().t != PVal::LIST) return -41;
          stack.back().items.push_back(std::move(x));
          break;
        }
        case 'e': {  // APPENDS
          std::vector<PVal> xs;
          if (!pop_mark(&xs) || stack.empty() || stack.back().t != PVal::LIST) return -41;
          for (auto& x : xs) stack.back().items.push_back(std::move(x));
          break;
        }
        case 's': {  // SETITEM — retain: DICT items hold [k0,v0,k1,v1,...]
          PVal v, k;
          if (!pop(&v) || !pop(&k) || stack.empty() || stack.back().t != PVal::DICT) return -41;
          stack.back().items.push_back(std::move(k));
          stack.back().items.push_back(std::move(v));
          break;
        }
        case 'u': {  // SETITEMS
          std::vector<PVal> kv;
          if (!pop_mark(&kv) || stack.empty() || stack.back().t != PVal::DICT) return -41;
          if (kv.size() % 2 != 0) return -41;
          for (auto& x : kv) stack.back().items.push_back(std::move(x));
          break;
        }
        case 'b': {  // BUILD: drop the state (OrderedDict's {'_metadata': ...}
          // instance dict — key maps and tensor payloads never live there).
          PVal state;
          if (!pop(&state) || stack.empty()) return -41;
          if (stack.back().t != PVal::DICT && stack.back().t != PVal::OBJ) return -41;
          break;
        }
        case 'q': {  // BINPUT
          unsigned char k;
          if (!take(&k, 1) || stack.empty()) return -41;
          memo[k] = stack.back();
          break;
        }
        case 'r': {  // LONG_BINPUT
          unsigned char b[4];
          if (!take(b, 4) || stack.empty()) return -41;
          memo[rd32(b)] = stack.back();
          break;
        }
        case 0x94: {  // MEMOIZE
          if (stack.empty()) return -41;
          memo[memo.size()] = stack.back();
          break;
        }
        case 'h': {  // BINGET
          unsigned char k;
          if (!take(&k, 1)) return -41;
          auto it = memo.find(k);
          if (it == memo.end()) return -41;
          stack.push_back(it->second);
          break;
        }
        case 'j': {  // LONG_BINGET
          unsigned char b[4];
          if (!take(b, 4)) return -41;
          auto it = memo.find(rd32(b));
          if (it == memo.end()) return -41;
          stack.push_back(it->second);
          break;
        }
        case 'Q': {  // BINPERSID
          PVal pid;
          if (!pop(&pid)) return -41;
          PVal v; v.t = PVal::PERSID;
          if (pid.t == PVal::TUPLE) v.items = std::move(pid.items);
          else v.items.push_back(std::move(pid));
          stack.push_back(std::move(v));
          break;
        }
        case 'R': {  // REDUCE
          PVal args, fn;
          if (!pop(&args) || !pop(&fn)) return -41;
          if (fn.t != PVal::GLOBAL || args.t != PVal::TUPLE) return -41;
          PVal v;
          if (fn.s == "collections OrderedDict") {
            v.t = PVal::DICT;  // backward-hooks placeholder
          } else {
            v.t = PVal::OBJ;
            v.s = std::move(fn.s);
            v.items = std::move(args.items);
          }
          stack.push_back(std::move(v));
          break;
        }
        default:
          return -41;  // opcode outside the torch.save(tensor) envelope
      }
    }
    return -41;  // ran off the end without STOP
  }
};

// Storage class name -> (result dtype code, element size). BFloat16Storage
// maps to f4 with `widen=true` (numpy has no bf16; equals torch .float()).
int storage_dtype(const std::string& cls, size_t* item, bool* widen) {
  *widen = false;
  if (cls == "torch FloatStorage") { *item = 4; return 0; }
  if (cls == "torch HalfStorage") { *item = 2; return 1; }
  if (cls == "torch DoubleStorage") { *item = 8; return 2; }
  if (cls == "torch CharStorage") { *item = 1; return 3; }
  if (cls == "torch ShortStorage") { *item = 2; return 4; }
  if (cls == "torch IntStorage") { *item = 4; return 5; }
  if (cls == "torch LongStorage") { *item = 8; return 6; }
  if (cls == "torch ByteStorage") { *item = 1; return 7; }
  if (cls == "torch BoolStorage") { *item = 1; return 7; }  // 0/1 bytes as u1
  if (cls == "torch BFloat16Storage") { *item = 2; *widen = true; return 0; }
  return -1;
}

bool pv_int(const PVal& v, int64_t* out) {
  if (v.t != PVal::INT && v.t != PVal::BOOL) return false;
  *out = v.i;
  return true;
}

// Materialize one unpickled _rebuild_tensor_v2 OBJ into a C-order Result,
// reading its storage payload from the zip.
int materialize_tensor(FILE* f, const std::vector<ZipEntry>& entries, const std::string& prefix,
                       const PVal& root, Result* r) {
  if (root.t != PVal::OBJ || root.s != "torch._utils _rebuild_tensor_v2" || root.items.size() < 4)
    return -42;  // not a plain tensor (sparse/quantized/... -> Python fallback)

  const PVal& pid = root.items[0];
  if (pid.t != PVal::PERSID || pid.items.size() < 5 || pid.items[0].t != PVal::STR ||
      pid.items[0].s != "storage" || pid.items[1].t != PVal::GLOBAL ||
      pid.items[2].t != PVal::STR)
    return -42;
  size_t item = 0;
  bool widen = false;
  int dtype = storage_dtype(pid.items[1].s, &item, &widen);
  if (dtype < 0) return -43;  // quantized/complex/... storage
  int64_t storage_numel = 0;
  if (!pv_int(pid.items[4], &storage_numel) || storage_numel < 0) return -42;

  int64_t offset = 0;
  if (!pv_int(root.items[1], &offset) || offset < 0) return -46;
  const PVal& size = root.items[2];
  const PVal& stride = root.items[3];
  if (size.t != PVal::TUPLE || stride.t != PVal::TUPLE || size.items.size() != stride.items.size())
    return -42;
  if (size.items.size() > 8) return -47;

  int ndim = (int)size.items.size();
  int64_t shp[8] = {0}, strd[8] = {0};
  size_t count = 1;
  int64_t extent = 1;  // storage elements spanned: 1 + sum((size_k-1)*stride_k)
  bool contiguous = true;
  int64_t contig = 1;
  for (int i = ndim - 1; i >= 0; --i) {
    if (!pv_int(size.items[i], &shp[i]) || !pv_int(stride.items[i], &strd[i])) return -42;
    if (shp[i] < 0 || strd[i] < 0) return -46;  // negative strides unsupported
    if (shp[i] == 0) { count = 0; }
    if (strd[i] != contig && shp[i] != 1) contiguous = false;
    contig *= shp[i];
  }
  for (int i = 0; i < ndim; ++i) {
    count *= (size_t)shp[i];
    if (shp[i] > 0) extent += (shp[i] - 1) * strd[i];
  }
  if (count == 0) extent = 0;
  if (offset + extent > storage_numel) return -46;

  const ZipEntry* payload = nullptr;
  std::string want = prefix + "data/" + pid.items[2].s;
  for (const auto& e : entries)
    if (e.name == want) { payload = &e; break; }
  if (!payload) return -44;
  if (payload->uncomp_size < (size_t)(storage_numel)*item) return -45;

  r->ndim = ndim;
  for (int i = 0; i < ndim; ++i) r->shape[i] = shp[i];
  r->dtype = dtype;
  size_t out_item = widen ? 4 : item;
  size_t nbytes = count * out_item;
  r->data = malloc(nbytes ? nbytes : 1);
  if (!r->data) return -14;
  int rc;

  if (contiguous && offset == 0 && !widen) {
    // Stream the payload straight into the result (the common case: the
    // reference's precomputed latents are contiguous offset-0 tensors).
    rc = count ? read_member_into(f, *payload, r->data, nbytes) : 0;
    if (rc != 0) { free(r->data); r->data = nullptr; }
    return rc;
  }

  // General case: read the spanned storage slice, then gather C-order.
  std::vector<unsigned char> raw((size_t)(offset + extent) * item);
  rc = count ? read_member_into(f, *payload, raw.data(), raw.size()) : 0;
  if (rc != 0) { free(r->data); r->data = nullptr; return rc; }
  const unsigned char* base = raw.data() + (size_t)offset * item;
  unsigned char* out = (unsigned char*)r->data;
  int64_t idx[8] = {0};
  for (size_t e = 0; e < count; ++e) {
    int64_t soff = 0;
    for (int i = 0; i < ndim; ++i) soff += idx[i] * strd[i];
    const unsigned char* src = base + (size_t)soff * item;
    if (widen) {  // bf16 -> f4: place the 16 payload bits in the f32 high half
      out[0] = 0; out[1] = 0; out[2] = src[0]; out[3] = src[1];
    } else {
      memcpy(out, src, item);
    }
    out += out_item;
    for (int i = ndim - 1; i >= 0; --i) {
      if (++idx[i] < shp[i]) break;
      idx[i] = 0;
    }
  }
  return 0;
}

// Locate `*/data.pkl` among the zip entries; returns nullptr if absent.
const ZipEntry* find_data_pkl(const std::vector<ZipEntry>& entries) {
  for (const auto& e : entries)
    if (e.name == "data.pkl" ||
        (e.name.size() > 9 && e.name.compare(e.name.size() - 9, 9, "/data.pkl") == 0))
      return &e;
  return nullptr;
}

// Read + unpickle `*/data.pkl`; on success sets *prefix to the archive's
// member prefix (e.g. "sd_test/") and leaves the root object in *root.
int unpickle_data_pkl(FILE* f, const std::vector<ZipEntry>& entries, std::string* prefix,
                      PVal* root) {
  const ZipEntry* pkl = find_data_pkl(entries);
  if (!pkl) return -40;
  *prefix = pkl->name.substr(0, pkl->name.size() - strlen("data.pkl"));
  std::string pk(pkl->uncomp_size, '\0');
  int rc = read_member_into(f, *pkl, pk.empty() ? (void*)&rc : (void*)&pk[0], pk.size());
  if (rc != 0) return rc;
  Unpickler u{(const unsigned char*)pk.data(), pk.size()};
  return u.run(root);
}

// Load the single tensor out of a torch .pt zip (entries already scanned).
int load_pt(FILE* f, const std::vector<ZipEntry>& entries, Result* r) {
  std::string prefix;
  PVal root;
  int rc = unpickle_data_pkl(f, entries, &prefix, &root);
  if (rc != 0) return rc;
  return materialize_tensor(f, entries, prefix, root, r);
}

// --------------------------------------------------------------------------
// Dict-of-tensor .pt (VAE/state-dict checkpoints): a handle over the parsed
// pickle that materializes named tensors lazily. Single-threaded use only
// (the gets share the handle's FILE*).
// --------------------------------------------------------------------------

struct PtDict {
  FILE* f = nullptr;
  std::vector<ZipEntry> entries;
  std::string prefix;
  std::vector<std::pair<std::string, PVal>> tensors;  // flattened dotted names
  ~PtDict() {
    if (f) fclose(f);
  }
};

// Flatten nested dicts with dotted prefixes; keep only plain-tensor leaves.
// (State-dict keys already contain dots — the dotted join matches how the
// Python side strips the optional leading "state_dict." wrapper.)
int flatten_dict(const PVal& d, const std::string& at, int depth,
                 std::vector<std::pair<std::string, PVal>>* out) {
  if (depth > 8) return -48;
  for (size_t i = 0; i + 1 < d.items.size(); i += 2) {
    const PVal& k = d.items[i];
    const PVal& v = d.items[i + 1];
    std::string name;
    if (k.t == PVal::STR) name = k.s;
    else if (k.t == PVal::INT) name = std::to_string(k.i);
    else continue;  // exotic key: skip the entry (fail-soft like torch iteration)
    std::string full = at.empty() ? name : at + "." + name;
    if (v.t == PVal::DICT) {
      int rc = flatten_dict(v, full, depth + 1, out);
      if (rc != 0) return rc;
    } else if (v.t == PVal::OBJ && v.s == "torch._utils _rebuild_tensor_v2") {
      out->emplace_back(std::move(full), v);
    }  // non-tensor leaves (ints, strings, hyperparams) are skipped
  }
  return 0;
}

int pt_dict_open(const char* path, PtDict** out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  unsigned char m4[4];
  if (fread(m4, 1, 4, f) != 4 || memcmp(m4, "PK\x03\x04", 4) != 0) {
    fclose(f);
    return -40;  // legacy non-zip .pt
  }
  auto h = new PtDict();
  h->f = f;
  int rc = scan_zip(f, &h->entries);
  PVal root;
  if (rc == 0) rc = unpickle_data_pkl(f, h->entries, &h->prefix, &root);
  if (rc == 0) {
    if (root.t != PVal::DICT) rc = -42;  // not a dict checkpoint
    else rc = flatten_dict(root, "", 0, &h->tensors);
  }
  if (rc != 0) {
    delete h;
    return rc;
  }
  *out = h;
  return 0;
}

int load_any(const char* path, Result* r) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  unsigned char m4[4];
  size_t got = fread(m4, 1, 4, f);
  int rc;
  if (got == 4 && memcmp(m4, "PK\x03\x04", 4) == 0) {
    std::vector<ZipEntry> entries;
    rc = scan_zip(f, &entries);
    if (rc == 0) {
      if (find_data_pkl(entries)) {
        rc = load_pt(f, entries, r);
      } else {
        // .npz: the FIRST .npy member — what np.load(...)[first key] reads.
        const ZipEntry* npy = nullptr;
        for (const auto& e : entries)
          if (e.name.size() >= 4 && e.name.compare(e.name.size() - 4, 4, ".npy") == 0) {
            npy = &e;
            break;
          }
        if (!npy) {
          rc = -34;
        } else if (npy->method != 0 && npy->method != 8) {
          rc = -33;
        } else if ((rc = seek_member(f, *npy)) == 0) {
          if (npy->method == 0) {
            FileReader in(f, npy->comp_size);
            rc = load_npy_stream(in, r);
          } else {
            InflateReader in(f, npy->comp_size);
            rc = load_npy_stream(in, r);
          }
        }
      }
    }
  } else {
    if (fseek(f, 0, SEEK_SET) != 0) {
      rc = -10;
    } else {
      FileReader in(f, (size_t)-1);
      rc = load_npy_stream(in, r);
    }
  }
  fclose(f);
  return rc;
}

struct Pool {
  std::vector<std::thread> workers;
  std::deque<std::pair<int64_t, std::string>> queue;
  std::map<int64_t, Result> done;
  std::map<int64_t, int> pending;  // queued or in-flight job ids (count)
  std::mutex mu;
  std::condition_variable cv_task, cv_done;
  bool stop = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) workers.emplace_back([this] { run(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_task.notify_all();
    for (auto& t : workers) t.join();
    for (auto& kv : done) free(kv.second.data);
  }

  void run() {
    for (;;) {
      std::pair<int64_t, std::string> task;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_task.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        task = queue.front();
        queue.pop_front();
      }
      Result r;
      r.status = load_any(task.second.c_str(), &r);
      {
        std::lock_guard<std::mutex> lk(mu);
        auto it = done.find(task.first);
        if (it != done.end()) free(it->second.data);  // duplicate id: drop stale payload
        done[task.first] = r;
        auto pit = pending.find(task.first);
        if (pit != pending.end() && --pit->second == 0) pending.erase(pit);
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* nl_pool_create(int num_threads) {
  // Keep multi-MB payload buffers on malloc arenas instead of fresh mmaps:
  // buffers are allocated by worker threads and freed from the consumer
  // (numpy finalizer), which defeats glibc's dynamic mmap-threshold
  // recycling — every batch then pays a first-touch page-fault storm and
  // the pooled path measured 0.5x of sequential np.load on page-cached
  // files (scripts/microbench.py --which loader).
  mallopt(M_MMAP_THRESHOLD, 24 << 20);  // glibc caps the threshold at 32 MB; >max fails silently
  return new Pool(num_threads > 0 ? num_threads : 2);
}

void nl_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

void nl_submit(void* pool, int64_t id, const char* path) {
  Pool* p = static_cast<Pool*>(pool);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->queue.emplace_back(id, std::string(path));
    p->pending[id]++;
  }
  p->cv_task.notify_one();
}

// Blocks until job `id` completes. On success returns 0 and transfers
// ownership of *data to the caller (release with nl_free). Waiting on an id
// that was never submitted (and has no buffered result) returns -20 instead
// of blocking forever.
int nl_wait(void* pool, int64_t id, void** data, int64_t* shape, int32_t* ndim, int32_t* dtype) {
  Pool* p = static_cast<Pool*>(pool);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [&] { return p->done.count(id) > 0 || p->pending.count(id) == 0; });
  if (p->done.count(id) == 0) return -20;  // unknown id
  Result r = p->done[id];
  p->done.erase(id);
  lk.unlock();
  if (r.status != 0) {
    free(r.data);
    return r.status;
  }
  *data = r.data;
  for (int i = 0; i < r.ndim; ++i) shape[i] = r.shape[i];
  *ndim = r.ndim;
  *dtype = r.dtype;
  return 0;
}

void nl_free(void* data) { free(data); }

// Synchronous single-file load (no pool) — used by load_tensor's fast path.
int nl_load(const char* path, void** data, int64_t* shape, int32_t* ndim, int32_t* dtype) {
  Result r;
  int rc = load_any(path, &r);
  if (rc != 0) return rc;
  *data = r.data;
  for (int i = 0; i < r.ndim; ++i) shape[i] = r.shape[i];
  *ndim = r.ndim;
  *dtype = r.dtype;
  return 0;
}

// Open a dict-of-tensor .pt checkpoint. Returns a handle (close with
// nl_pt_dict_close) and writes the flattened tensor count, or NULL with a
// negative *err (caller falls back to torch.load). Handles are NOT
// thread-safe: gets share the handle's file stream.
void* nl_pt_dict_open(const char* path, int32_t* count, int32_t* err) {
  PtDict* h = nullptr;
  int rc = pt_dict_open(path, &h);
  if (rc != 0) {
    if (err) *err = rc;
    return nullptr;
  }
  if (count) *count = (int32_t)h->tensors.size();
  if (err) *err = 0;
  return h;
}

// Dotted name of tensor i (valid until nl_pt_dict_close); NULL if out of range.
const char* nl_pt_dict_name(void* handle, int32_t i) {
  PtDict* h = static_cast<PtDict*>(handle);
  if (!h || i < 0 || (size_t)i >= h->tensors.size()) return nullptr;
  return h->tensors[i].first.c_str();
}

// Materialize tensor i into a fresh malloc'd buffer (release with nl_free).
int nl_pt_dict_get(void* handle, int32_t i, void** data, int64_t* shape, int32_t* ndim,
                   int32_t* dtype) {
  PtDict* h = static_cast<PtDict*>(handle);
  if (!h || i < 0 || (size_t)i >= h->tensors.size()) return -49;
  Result r;
  int rc = materialize_tensor(h->f, h->entries, h->prefix, h->tensors[i].second, &r);
  if (rc != 0) return rc;
  *data = r.data;
  for (int k = 0; k < r.ndim; ++k) shape[k] = r.shape[k];
  *ndim = r.ndim;
  *dtype = r.dtype;
  return 0;
}

void nl_pt_dict_close(void* handle) { delete static_cast<PtDict*>(handle); }

}  // extern "C"
