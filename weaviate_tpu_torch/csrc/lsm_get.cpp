// Native LSM point-get plane of the PyTorch/CUDA port: mmap'd segment
// readers + batched multi-get, built by storage/lsm_native.py.
//
// The serving hot path hydrates thousands of winners per batch with two
// point lookups each (docid -> uuid, uuid -> object image). In Python that
// is a bisect over per-segment key lists under the bucket lock WITH the GIL
// held. Here a batch is one C call, which releases the GIL (ctypes): it
// finds every key once (one open-addressing hash probe a segment, newest
// first), through both buckets when asked to (the doc id's uuid, then the
// uuid's image), sums the found values' bytes, allocates an arena of
// exactly that size and copies the values into it. So no key is searched
// twice, no copy is thrown away, and the serving thread takes the GIL back
// once a hydration.
//
// Reference analog: the batched hydration seam of
// entities/storobj/storage_object.go:211 (ObjectsByDocID) over lsmkv's
// compiled segment readers — the same tier for the Python runtime.
//
// Segment layout (storage/lsm.py Segment):
//   "WTSG" | strategy u8 | entries... | footer | footer_off u64
//   footer: count u64, then per entry: klen u32 | key | off u64 | len u64
// Only STRATEGY_REPLACE (index 0) segments are served here.
//
// Hash table: built once when a segment is opened (its first native use),
// over the parsed footer. Slots are u32: the entry index + 1 in the low
// `ebits` bits (the width of the entry count), a tag of the hash's high
// half in the bits above, 0 for empty. There are three slots an entry
// (12 B an entry beside the 32 B Entry), so the load factor is 1/3 and a
// search for an absent key (the usual case in every segment newer than the
// key's) touches ~1.6 slots, a present one ~1.25. A probe walks linearly
// from the slot the hash's low half maps to; a slot whose tag matches is
// confirmed by comparing the key bytes, so every answer is exact.
//
// Concurrency contract with the Python side (storage/lsm.py Bucket):
//   - the caller snapshots the segment handle list under the bucket lock
//     and bumps an in-flight counter;
//   - compaction retires (never closes) segments while calls are in
//     flight, so every handle passed in stays valid for the whole call;
//   - handles are immutable after open — no locking needed here;
//   - the caller owns the arena a call returns and frees it with
//     lsm_arena_free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <vector>

namespace {

constexpr unsigned char kMagic[4] = {'W', 'T', 'S', 'G'};

// storage/lsm.py _TOMBSTONE = b"\x00__wt_tombstone__"
constexpr unsigned char kTomb[] = "\x00__wt_tombstone__";
constexpr int64_t kTombLen = 17;

struct Entry {
    const uint8_t* key;
    uint64_t key_len;
    uint64_t off;
    uint64_t len;
};

struct Seg {
    int fd = -1;
    const uint8_t* base = nullptr;
    size_t size = 0;
    std::vector<Entry> entries;
    std::vector<uint32_t> slots;  // tag | (entry + 1); 0 = empty
    uint32_t tag_mask = 0;        // the bits above the entry index
};

inline uint64_t fmix64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

// over the whole key: 8-byte words, then the tail, then the length
inline uint64_t hash_key(const uint8_t* k, uint64_t n) {
    uint64_t h = 0x9e3779b97f4a7c15ULL;
    const uint64_t len = n;
    while (n >= 8) {
        uint64_t w;
        std::memcpy(&w, k, 8);
        h = fmix64(h ^ w) + 0x9e3779b97f4a7c15ULL;
        k += 8;
        n -= 8;
    }
    if (n) {
        uint64_t w = 0;
        std::memcpy(&w, k, n);
        h = fmix64(h ^ w) + 0x9e3779b97f4a7c15ULL;
    }
    return fmix64(h ^ len);
}

// the hash's low half mapped onto [0, n_slots) (n_slots < 2^32)
inline uint64_t home_of(uint64_t h, uint64_t n_slots) {
    return ((h & 0xffffffffULL) * n_slots) >> 32;
}

void build_table(Seg& s) {
    const uint64_t count = s.entries.size();
    const uint64_t n_slots = 3 * count + 1;
    int ebits = 0;
    while ((count >> ebits) != 0) ebits++;
    s.tag_mask = ebits >= 32 ? 0 : ~((uint32_t{1} << ebits) - 1);
    s.slots.assign(n_slots, 0);
    for (size_t e = 0; e < count; e++) {
        const Entry& ent = s.entries[e];
        const uint64_t h = hash_key(ent.key, ent.key_len);
        uint64_t i = home_of(h, n_slots);
        while (s.slots[i] != 0) i = i + 1 == n_slots ? 0 : i + 1;
        s.slots[i] = (static_cast<uint32_t>(h >> 32) & s.tag_mask) |
                     static_cast<uint32_t>(e + 1);
    }
}

// -> entry index or -1; `probes` grows by the slots touched
inline int64_t seg_find(const Seg& s, const uint8_t* key, uint64_t klen,
                        uint64_t h, int64_t& probes) {
    const uint64_t n_slots = s.slots.size();
    const uint32_t tag = static_cast<uint32_t>(h >> 32) & s.tag_mask;
    uint64_t i = home_of(h, n_slots);
    for (;;) {
        const uint32_t slot = s.slots[i];
        probes++;
        if (slot == 0) return -1;
        if ((slot & s.tag_mask) == tag) {
            const uint32_t e = (slot & ~s.tag_mask) - 1;
            const Entry& ent = s.entries[e];
            if (ent.key_len == klen && std::memcmp(ent.key, key, klen) == 0)
                return static_cast<int64_t>(e);
        }
        i = i + 1 == n_slots ? 0 : i + 1;
    }
}

// The value of `key` in a NEWEST-FIRST segment list: its address and
// length, or nullptr when absent or tombstoned (a tombstone in a newer
// segment shadows older values). `searched` and `probes` grow.
inline const uint8_t* list_find(void* const* segs, int64_t n_segs,
                                const uint8_t* key, uint64_t klen,
                                uint64_t& len, int64_t& searched,
                                int64_t& probes) {
    const uint64_t h = hash_key(key, klen);
    for (int64_t si = 0; si < n_segs; si++) {
        const Seg& s = *static_cast<const Seg*>(segs[si]);
        searched++;
        const int64_t e = seg_find(s, key, klen, h, probes);
        if (e < 0) continue;
        const Entry& ent = s.entries[static_cast<size_t>(e)];
        if (ent.len == static_cast<uint64_t>(kTombLen) &&
            std::memcmp(s.base + ent.off, kTomb, kTombLen) == 0)
            return nullptr;
        len = ent.len;
        return s.base + ent.off;
    }
    return nullptr;
}

}  // namespace

extern "C" {

// -> opaque handle, or nullptr on any parse/IO failure (caller falls back
// to the Python reader).
void* lsm_seg_open(const char* path) {
    int fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return nullptr;
    struct stat st;
    if (::fstat(fd, &st) != 0 || st.st_size < 4 + 1 + 8 + 8) {
        ::close(fd);
        return nullptr;
    }
    void* base = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                        MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) {
        ::close(fd);
        return nullptr;
    }
    auto* s = new Seg();
    s->fd = fd;
    s->base = static_cast<const uint8_t*>(base);
    s->size = static_cast<size_t>(st.st_size);
    // all bounds checks below are written subtraction-style against the
    // remaining byte count: `off + len > size` can WRAP for a corrupt file
    // whose offsets decode near UINT64_MAX, passing the check and crashing
    // the process — the contract here is nullptr-and-fallback, never a crash
    const uint8_t* p = s->base;
    const uint64_t size = s->size;
    bool ok = std::memcmp(p, kMagic, 4) == 0 && p[4] == 0 /* replace */;
    if (ok) {
        uint64_t footer_off;
        std::memcpy(&footer_off, p + size - 8, 8);
        ok = footer_off <= size - 8 && size - 8 - footer_off >= 8;
        if (ok) {
            uint64_t count;
            std::memcpy(&count, p + footer_off, 8);
            uint64_t off = footer_off + 8;
            // min bytes per entry; the slot count (3 an entry) fits 32 bits
            ok = count <= (size - off) / (4 + 16) && count < 0x55555555ULL;
            if (ok) s->entries.reserve(count);
            for (uint64_t i = 0; i < count && ok; i++) {
                if (size - off < 4) { ok = false; break; }
                uint32_t klen;
                std::memcpy(&klen, p + off, 4);
                off += 4;
                if (size - off < klen || size - off - klen < 16) { ok = false; break; }
                Entry e;
                e.key = p + off;
                e.key_len = klen;
                off += klen;
                std::memcpy(&e.off, p + off, 8);
                std::memcpy(&e.len, p + off + 8, 8);
                off += 16;
                if (e.off > size || size - e.off < e.len) { ok = false; break; }
                s->entries.push_back(e);
            }
        }
    }
    if (!ok) {
        ::munmap(const_cast<uint8_t*>(s->base), s->size);
        ::close(s->fd);
        delete s;
        return nullptr;
    }
    build_table(*s);
    return s;
}

void lsm_seg_close(void* h) {
    if (h == nullptr) return;
    auto* s = static_cast<Seg*>(h);
    ::munmap(const_cast<uint8_t*>(s->base), s->size);
    ::close(s->fd);
    delete s;
}

int64_t lsm_seg_count(void* h) {
    return h ? static_cast<int64_t>(static_cast<Seg*>(h)->entries.size()) : 0;
}

// Batched replace-strategy point gets over a NEWEST-FIRST segment list,
// and optionally through a second one: with n_segs2 > 0 each found value
// is looked up as a key in segs2 (doc id -> uuid -> object image), and
// what that finds is the key's value.
//   keys/key_offs: concatenated key bytes, n_keys+1 prefix offsets; a
//     zero-length key (or a zero-length first value) means "missing
//     upstream" and stays missing.
//   arena:         set to a malloc'd arena holding the found values in key
//                  order, exactly out_offs[n_keys] bytes (nullptr when 0);
//                  the caller frees it with lsm_arena_free.
//   out_offs:      n_keys+1 prefix offsets into the arena (equal offsets =
//                  miss).
//   flags:         per key: 1 found, 0 missing (absent OR tombstoned).
//   stats:         [0] += segments searched over all keys and both lists,
//                  [1] += hash slots touched, [2] += arenas filled (each
//                  a pass that copies the found values), [3] += 1 (calls).
// -> the arena's size in bytes, or -1 when it cannot be allocated.
int64_t lsm_multi_get(void** segs, int64_t n_segs, void** segs2,
                      int64_t n_segs2, const uint8_t* keys,
                      const int64_t* key_offs, int64_t n_keys, uint8_t** arena,
                      int64_t* out_offs, int8_t* flags, int64_t* stats) {
    std::vector<const uint8_t*> src(static_cast<size_t>(n_keys), nullptr);
    int64_t need = 0;
    int64_t searched = 0;
    int64_t probes = 0;
    out_offs[0] = 0;
    for (int64_t i = 0; i < n_keys; i++) {
        uint64_t len = static_cast<uint64_t>(key_offs[i + 1] - key_offs[i]);
        const uint8_t* v = len > 0 ? keys + key_offs[i] : nullptr;
        if (v != nullptr)
            v = list_find(segs, n_segs, v, len, len, searched, probes);
        if (v != nullptr && n_segs2 > 0)
            v = len > 0 ? list_find(segs2, n_segs2, v, len, len, searched, probes)
                        : nullptr;
        flags[i] = v != nullptr;
        src[static_cast<size_t>(i)] = v;
        if (v != nullptr) need += static_cast<int64_t>(len);
        out_offs[i + 1] = need;
    }
    stats[0] += searched;
    stats[1] += probes;
    stats[3] += 1;
    *arena = nullptr;
    if (need == 0) return 0;
    auto* out = static_cast<uint8_t*>(std::malloc(static_cast<size_t>(need)));
    if (out == nullptr) return -1;
    for (int64_t i = 0; i < n_keys; i++) {
        const int64_t len = out_offs[i + 1] - out_offs[i];
        if (len > 0)
            std::memcpy(out + out_offs[i], src[static_cast<size_t>(i)],
                        static_cast<size_t>(len));
    }
    stats[2] += 1;
    *arena = out;
    return need;
}

void lsm_arena_free(void* arena) { std::free(arena); }

}  // extern "C"
