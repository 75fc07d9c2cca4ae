// cwfa_tpu native TIFF I/O + prefetch runtime.
//
// The reference delegates TIFF decode to python libraries (tifffile /
// multipagetiff, reference XLFMDataset.py:92,246) and loading the multipage
// camera stacks is the startup bottleneck (SURVEY.md §7 "Host I/O").  This
// library provides:
//   - a zero-copy-ish multipage TIFF reader for the formats the pipeline
//     produces and consumes (uncompressed grayscale uint8/uint16/float32,
//     strip- or single-strip layouts, both endiannesses, TIFF classic),
//   - a background prefetcher: a worker thread decodes frame n+1 while the
//     device computes on frame n (double buffering).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// The PyTorch port's copy of native/tiffio.cpp.  It differs in the guards
// of the IFD walk only, so that a corrupt file fails to open instead of
// crashing or hanging the process: a tag with a count of 0 (the original
// reads vals[0] of an empty vector), a tag whose values would lie past
// the end of the file, an IFD chain that loops, and an allocation failure
// inside the walk.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <queue>
#include <set>

namespace {

struct Ifd {
  uint64_t width = 0, height = 0;
  uint16_t bits = 0, sample_format = 1, compression = 1, samples = 1;
  std::vector<uint64_t> strip_offsets;
  std::vector<uint64_t> strip_bytes;
  uint64_t rows_per_strip = 0;
};

struct TiffFile {
  FILE* f = nullptr;
  bool big_endian = false;
  uint64_t file_size = 0;
  std::vector<Ifd> ifds;
  std::string error;
};

uint16_t swap16(uint16_t v) { return (uint16_t)((v >> 8) | (v << 8)); }
uint32_t swap32(uint32_t v) {
  return (v >> 24) | ((v >> 8) & 0xff00u) | ((v << 8) & 0xff0000u) | (v << 24);
}

uint16_t rd16(TiffFile* t, const uint8_t* p) {
  uint16_t v; memcpy(&v, p, 2);
  return t->big_endian ? swap16(v) : v;
}
uint32_t rd32(TiffFile* t, const uint8_t* p) {
  uint32_t v; memcpy(&v, p, 4);
  return t->big_endian ? swap32(v) : v;
}

// Read one IFD entry value (SHORT/LONG scalar or array).
bool read_tag_values(TiffFile* t, const uint8_t entry[12],
                     std::vector<uint64_t>* out) {
  uint16_t type = rd16(t, entry + 2);
  uint32_t count = rd32(t, entry + 4);
  uint32_t value_size = (type == 3) ? 2 : (type == 4) ? 4 : 0;
  if (value_size == 0 || count == 0) return false;
  uint64_t total = (uint64_t)value_size * count;
  if (t->file_size && total > t->file_size) return false;
  out->resize(count);
  uint8_t local[4];
  const uint8_t* src = entry + 8;
  std::vector<uint8_t> buf;
  if (total > 4) {
    uint32_t off = rd32(t, entry + 8);
    buf.resize(total);
    if (fseek(t->f, off, SEEK_SET) != 0) return false;
    if (fread(buf.data(), 1, total, t->f) != total) return false;
    src = buf.data();
  } else {
    memcpy(local, src, 4);
    src = local;
  }
  for (uint32_t i = 0; i < count; i++) {
    (*out)[i] = (value_size == 2) ? rd16(t, src + 2 * i) : rd32(t, src + 4 * i);
  }
  return true;
}

bool parse_ifds(TiffFile* t) {
  uint8_t hdr[8];
  if (fread(hdr, 1, 8, t->f) != 8) { t->error = "short header"; return false; }
  if (hdr[0] == 'I' && hdr[1] == 'I') t->big_endian = false;
  else if (hdr[0] == 'M' && hdr[1] == 'M') t->big_endian = true;
  else { t->error = "not a TIFF"; return false; }
  if (rd16(t, hdr + 2) != 42) { t->error = "not classic TIFF"; return false; }
  uint32_t off = rd32(t, hdr + 4);
  std::set<uint32_t> visited;
  while (off != 0) {
    if (!visited.insert(off).second) { t->error = "IFD loop"; return false; }
    if (fseek(t->f, off, SEEK_SET) != 0) { t->error = "bad IFD offset"; return false; }
    uint8_t cntb[2];
    if (fread(cntb, 1, 2, t->f) != 2) { t->error = "short IFD"; return false; }
    uint16_t n = rd16(t, cntb);
    std::vector<uint8_t> entries(12ull * n + 4);
    if (fread(entries.data(), 1, entries.size(), t->f) != entries.size()) {
      t->error = "short IFD entries"; return false;
    }
    Ifd ifd;
    for (uint16_t i = 0; i < n; i++) {
      const uint8_t* e = entries.data() + 12ull * i;
      uint16_t tag = rd16(t, e);
      std::vector<uint64_t> vals;
      switch (tag) {
        case 256: if (read_tag_values(t, e, &vals)) ifd.width = vals[0]; break;
        case 257: if (read_tag_values(t, e, &vals)) ifd.height = vals[0]; break;
        case 258: if (read_tag_values(t, e, &vals)) ifd.bits = (uint16_t)vals[0]; break;
        case 259: if (read_tag_values(t, e, &vals)) ifd.compression = (uint16_t)vals[0]; break;
        case 273: if (read_tag_values(t, e, &vals)) ifd.strip_offsets = vals; break;
        case 277: if (read_tag_values(t, e, &vals)) ifd.samples = (uint16_t)vals[0]; break;
        case 278: if (read_tag_values(t, e, &vals)) ifd.rows_per_strip = vals[0]; break;
        case 279: if (read_tag_values(t, e, &vals)) ifd.strip_bytes = vals; break;
        case 339: if (read_tag_values(t, e, &vals)) ifd.sample_format = (uint16_t)vals[0]; break;
        default: break;
      }
    }
    t->ifds.push_back(ifd);
    off = rd32(t, entries.data() + 12ull * n);
  }
  return true;
}

void byteswap_buf(uint8_t* data, uint64_t n_elems, int elem_size) {
  if (elem_size == 2) {
    uint16_t* p = (uint16_t*)data;
    for (uint64_t i = 0; i < n_elems; i++) p[i] = swap16(p[i]);
  } else if (elem_size == 4) {
    uint32_t* p = (uint32_t*)data;
    for (uint64_t i = 0; i < n_elems; i++) p[i] = swap32(p[i]);
  }
}

}  // namespace

extern "C" {

// ---- reader -------------------------------------------------------------

void* tiff_open(const char* path) {
  auto* t = new TiffFile();
  t->f = fopen(path, "rb");
  if (!t->f) { delete t; return nullptr; }
  if (fseek(t->f, 0, SEEK_END) == 0) {
    long sz = ftell(t->f);
    t->file_size = sz > 0 ? (uint64_t)sz : 0;
  }
  bool ok = false;
  try {
    ok = fseek(t->f, 0, SEEK_SET) == 0 && parse_ifds(t);
  } catch (...) {          // std::bad_alloc from a corrupt count
    ok = false;
  }
  if (!ok) {
    fclose(t->f); delete t; return nullptr;
  }
  return t;
}

int tiff_num_pages(void* h) { return (int)((TiffFile*)h)->ifds.size(); }

// dims[0]=height, dims[1]=width; dtype: 1=u8, 2=u16, 3=f32. returns 0 on ok
int tiff_page_info(void* h, int page, int64_t* dims, int* dtype) {
  auto* t = (TiffFile*)h;
  if (page < 0 || page >= (int)t->ifds.size()) return -1;
  const Ifd& p = t->ifds[page];
  if (p.compression != 1 || p.samples != 1) return -2;
  dims[0] = (int64_t)p.height; dims[1] = (int64_t)p.width;
  if (p.bits == 8) *dtype = 1;
  else if (p.bits == 16) *dtype = 2;
  else if (p.bits == 32 && p.sample_format == 3) *dtype = 3;
  else return -3;
  // corrupt-IFD guards: a zero-dim page, or a pixel payload larger than
  // the file itself (we only read uncompressed data), means the geometry
  // tags lie — reject BEFORE the caller allocates height*width*elem
  if (p.width == 0 || p.height == 0) return -5;
  uint64_t need = p.width * p.height * (uint64_t)(p.bits / 8);
  if (need / p.width / p.height != (uint64_t)(p.bits / 8)) return -5;
  if (t->file_size && need > t->file_size) return -5;
  return 0;
}

// out must hold height*width*elem_size bytes
int tiff_read_page(void* h, int page, uint8_t* out) {
  auto* t = (TiffFile*)h;
  if (page < 0 || page >= (int)t->ifds.size()) return -1;
  const Ifd& p = t->ifds[page];
  int elem = p.bits / 8;
  uint64_t row_bytes = p.width * (uint64_t)elem;
  uint64_t written = 0;
  uint64_t need = row_bytes * p.height;
  for (size_t s = 0; s < p.strip_offsets.size(); s++) {
    uint64_t nbytes = s < p.strip_bytes.size() ? p.strip_bytes[s]
                                               : need - written;
    if (written + nbytes > need) nbytes = need - written;
    if (fseek(t->f, (long)p.strip_offsets[s], SEEK_SET) != 0) return -2;
    if (fread(out + written, 1, nbytes, t->f) != nbytes) return -3;
    written += nbytes;
  }
  if (written != need) return -4;
  if (t->big_endian && elem > 1)
    byteswap_buf(out, need / elem, elem);
  return 0;
}

void tiff_close(void* h) {
  auto* t = (TiffFile*)h;
  if (t->f) fclose(t->f);
  delete t;
}

// ---- writer (uncompressed single-strip little-endian) -------------------

// dtype: 1=u8, 2=u16, 3=f32
int tiff_write(const char* path, const uint8_t* data, int n_pages,
               int64_t height, int64_t width, int dtype) {
  int elem = dtype == 1 ? 1 : dtype == 2 ? 2 : 4;
  uint16_t bits = (uint16_t)(8 * elem);
  uint16_t sf = dtype == 3 ? 3 : 1;
  uint64_t page_bytes = (uint64_t)height * width * elem;
  const uint16_t n_entries = 8;
  uint32_t ifd_size = 2 + 12 * n_entries + 4;
  // classic (non-Big) TIFF offsets are u32: refuse files that would wrap
  // past 4 GB instead of silently writing corrupt IFD offsets — the
  // Python caller falls back to another writer on a nonzero return.
  uint64_t total = 8 + (uint64_t)n_pages * (ifd_size + page_bytes);
  if (total > 0xFFFFFFFFull || page_bytes > 0xFFFFFFFFull) return -2;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint8_t hdr[8] = {'I', 'I', 42, 0, 8, 0, 0, 0};
  fwrite(hdr, 1, 8, f);
  uint32_t off = 8;
  for (int pg = 0; pg < n_pages; pg++) {
    uint32_t data_off = off + ifd_size;
    uint32_t next_ifd = (pg + 1 < n_pages)
        ? (uint32_t)(data_off + page_bytes) : 0;
    uint8_t ifd[2 + 12 * 8 + 4];
    memset(ifd, 0, sizeof(ifd));
    uint16_t cnt = n_entries; memcpy(ifd, &cnt, 2);
    auto put = [&](int i, uint16_t tag, uint16_t type, uint32_t count,
                   uint32_t value) {
      uint8_t* e = ifd + 2 + 12 * i;
      memcpy(e, &tag, 2); memcpy(e + 2, &type, 2);
      memcpy(e + 4, &count, 4); memcpy(e + 8, &value, 4);
    };
    put(0, 256, 4, 1, (uint32_t)width);          // ImageWidth
    put(1, 257, 4, 1, (uint32_t)height);         // ImageLength
    put(2, 258, 3, 1, bits);                     // BitsPerSample
    put(3, 259, 3, 1, 1);                        // Compression = none
    put(4, 262, 3, 1, 1);                        // Photometric = minisblack
    put(5, 273, 4, 1, data_off);                 // StripOffsets
    put(6, 279, 4, 1, (uint32_t)page_bytes);     // StripByteCounts
    put(7, 339, 3, 1, sf);                       // SampleFormat
    memcpy(ifd + 2 + 12 * n_entries, &next_ifd, 4);
    fwrite(ifd, 1, sizeof(ifd), f);
    fwrite(data + (uint64_t)pg * page_bytes, 1, page_bytes, f);
    off = data_off + (uint32_t)page_bytes;
  }
  fclose(f);
  return 0;
}

// ---- prefetcher ---------------------------------------------------------
//
// Background worker decoding pages ahead of the consumer; classic
// double/triple-buffered producer-consumer ring.

struct Prefetcher {
  TiffFile* tiff;
  std::vector<int> pages;
  uint64_t page_bytes;
  size_t depth;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::queue<std::pair<int, std::vector<uint8_t>>> ready;
  bool stop = false;
  bool done = false;     // worker exhausted its page list normally
  std::string err;

  void run() {
    for (int pg : pages) {
      // every page must match the first selected page's geometry: the
      // buffers here AND the consumer's numpy arrays are sized/typed from
      // it, and tiff_read_page writes the page's OWN bytes — a larger
      // page would overflow the heap buffer, and an equal-byte page of
      // different shape/dtype would be silently reinterpreted.
      bool ok_geom = pg >= 0 && pg < (int)tiff->ifds.size();
      if (ok_geom) {
        const Ifd& p = tiff->ifds[pg];
        const Ifd& p0 = tiff->ifds[pages[0]];
        ok_geom = p.height == p0.height && p.width == p0.width
                  && p.bits == p0.bits && p.sample_format == p0.sample_format;
      }
      if (!ok_geom) {
        std::unique_lock<std::mutex> lk(mu);
        err = "page geometry mismatch";
        cv_ready.notify_all();
        return;
      }
      std::vector<uint8_t> buf(page_bytes);
      int rc = tiff_read_page(tiff, pg, buf.data());
      std::unique_lock<std::mutex> lk(mu);
      if (rc != 0) { err = "read error"; cv_ready.notify_all(); return; }
      cv_free.wait(lk, [&] { return ready.size() < depth || stop; });
      if (stop) return;
      ready.emplace(pg, std::move(buf));
      cv_ready.notify_one();
    }
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv_ready.notify_all();
  }
};

void* prefetch_start(void* tiff_handle, const int* pages, int n_pages,
                     int depth) {
  auto* t = (TiffFile*)tiff_handle;
  if (t->ifds.empty() || n_pages <= 0) return nullptr;
  // size buffers from the FIRST SELECTED page (the Python consumer sizes
  // its arrays from the same page via tiff_page_info)
  if (pages[0] < 0 || pages[0] >= (int)t->ifds.size()) return nullptr;
  const Ifd& p0 = t->ifds[pages[0]];
  auto* pf = new Prefetcher();
  pf->tiff = t;
  pf->pages.assign(pages, pages + n_pages);
  pf->page_bytes = (uint64_t)p0.height * p0.width * (p0.bits / 8);
  pf->depth = depth > 0 ? (size_t)depth : 2;
  pf->worker = std::thread([pf] { pf->run(); });
  return pf;
}

// blocks until the next page is decoded; returns page index or -1 when done
// or on error (already-decoded pages are drained BEFORE the error shows —
// check prefetch_error after a -1 to distinguish the two)
int prefetch_next(void* h, uint8_t* out) {
  auto* pf = (Prefetcher*)h;
  if (!pf) return -1;
  std::unique_lock<std::mutex> lk(pf->mu);
  pf->cv_ready.wait(lk, [&] {
    return !pf->ready.empty() || !pf->err.empty() || pf->stop || pf->done;
  });
  if (pf->ready.empty()) return -1;   // done, stopped, or errored dry
  auto item = std::move(pf->ready.front());
  pf->ready.pop();
  pf->cv_free.notify_one();
  lk.unlock();
  memcpy(out, item.second.data(), item.second.size());
  return item.first;
}

// non-empty error string after a -1 means the decode FAILED mid-stream
// (geometry mismatch / read error) rather than completing; the pointer
// stays valid until prefetch_stop
const char* prefetch_error(void* h) {
  auto* pf = (Prefetcher*)h;
  if (!pf) return "prefetch start failed";
  std::lock_guard<std::mutex> lk(pf->mu);
  return pf->err.empty() ? "" : pf->err.c_str();
}

void prefetch_stop(void* h) {
  auto* pf = (Prefetcher*)h;
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->stop = true;
  }
  pf->cv_free.notify_all();
  pf->cv_ready.notify_all();
  if (pf->worker.joinable()) pf->worker.join();
  delete pf;
}

}  // extern "C"
