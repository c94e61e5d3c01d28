// pagepool.cpp — native page allocator + admission control for the paged
// KV-cache serving engine.
//
// This is the framework's host-side native runtime piece (the role the
// reference's C++ sidecar plays for its CPU kernels, src_cpp/ — here it
// manages memory instead of doing math: the TPU does the math). The Python
// engine calls through ctypes (tpu_flash/cache/allocator.py).
//
// Design: O(1) page alloc/free via a free-list stack; per-slot page tables;
// atomic admission (all-or-nothing multi-page grants so a half-admitted
// sequence can never deadlock the pool); a watermark reservation so decode
// extends are never starved by new prefills. Thread-safe via one mutex —
// the engine loop is single-threaded, but request arrival may not be.

#include <cstdint>
#include <cstring>
#include <list>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct PagePool {
  int32_t total_pages;
  int32_t max_seqs;
  int32_t max_pages_per_seq;
  int32_t decode_reserve;  // pages kept back for decode extends
  std::vector<int32_t> free_stack;
  std::vector<std::vector<int32_t>> tables;  // per-slot page ids
  std::vector<uint8_t> active;
  // Reference counts enable copy-on-write page sharing (prefix caching):
  // each slot-table entry holds one ref, and the host-side prefix cache
  // holds one per retained page. A page returns to the free stack only
  // when its count reaches zero.
  std::vector<int32_t> refs;
  std::mutex mu;

  PagePool(int32_t total, int32_t seqs, int32_t per_seq, int32_t reserve)
      : total_pages(total),
        max_seqs(seqs),
        max_pages_per_seq(per_seq),
        decode_reserve(reserve),
        tables(seqs),
        active(seqs, 0),
        refs(total, 0) {
    free_stack.reserve(total);
    for (int32_t p = total - 1; p >= 0; --p) free_stack.push_back(p);
  }

  int32_t take_free() {
    int32_t p = free_stack.back();
    free_stack.pop_back();
    refs[p] = 1;
    return p;
  }

  void drop_ref(int32_t p) {
    if (--refs[p] == 0) free_stack.push_back(p);
  }

  // ---- prefix-cache index (content-addressed full prompt pages) -------
  //
  // Chains link by a MONOTONIC entry id (never a recyclable page id): a
  // key is (parent_entry_id, page_tokens); the chain anchors at -1. Each
  // entry holds one page reference; eviction is LRU via an intrusive
  // list. This is the host-runtime hot path of prefix caching — admission
  // walks it once per request — so it lives next to the allocator it
  // retains pages from.
  struct PcKey {
    int64_t parent;
    std::vector<int32_t> toks;
    bool operator==(const PcKey& o) const {
      return parent == o.parent && toks == o.toks;
    }
  };
  struct PcKeyHash {
    size_t operator()(const PcKey& k) const {
      size_t h = std::hash<int64_t>()(k.parent);
      for (int32_t t : k.toks) h = h * 1000003u + static_cast<size_t>(t) + 1;
      return h;
    }
  };
  struct PcEntry {
    int32_t page;
    int64_t id;
    // position in pc_lru (front = oldest); the list stores POINTERS to
    // the map keys, so each token vector exists exactly once and an LRU
    // touch is an O(1) splice with no copies
    std::list<const PcKey*>::iterator lru_it;
  };
  std::unordered_map<PcKey, PcEntry, PcKeyHash> pc_map;
  std::list<const PcKey*> pc_lru;
  int64_t pc_next_id = 0;
  int64_t pc_hits = 0, pc_misses = 0, pc_hit_tokens = 0;

  void pc_touch(PcEntry& e) {
    pc_lru.splice(pc_lru.end(), pc_lru, e.lru_it);
  }
};

}  // namespace

extern "C" {

void* pp_create(int32_t total_pages, int32_t max_seqs,
                int32_t max_pages_per_seq, int32_t decode_reserve) {
  if (total_pages <= 0 || max_seqs <= 0 || max_pages_per_seq <= 0) return nullptr;
  return new PagePool(total_pages, max_seqs, max_pages_per_seq,
                      decode_reserve < 0 ? 0 : decode_reserve);
}

void pp_destroy(void* h) { delete static_cast<PagePool*>(h); }

int32_t pp_num_free(void* h) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  return static_cast<int32_t>(pool->free_stack.size());
}

// Admit a sequence needing `npages` now. Fails (returns -1) unless
// npages + decode_reserve pages are free (all-or-nothing). Returns 0 on
// success; the slot's table is populated.
int32_t pp_admit(void* h, int32_t slot, int32_t npages) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (slot < 0 || slot >= pool->max_seqs || pool->active[slot]) return -1;
  if (npages < 0 || npages > pool->max_pages_per_seq) return -1;
  if (static_cast<int32_t>(pool->free_stack.size()) <
      npages + pool->decode_reserve)
    return -1;
  auto& table = pool->tables[slot];
  table.clear();
  for (int32_t i = 0; i < npages; ++i) table.push_back(pool->take_free());
  pool->active[slot] = 1;
  return 0;
}

// Admit a sequence whose table starts with `n_shared` EXISTING pages
// (prefix-cache hits; each gains a reference — copy-on-write sharing)
// followed by `n_new` fresh pages. All-or-nothing like pp_admit; only the
// fresh pages count against the free pool + decode reserve. Shared pages
// must currently be live (refcount > 0). Returns 0 on success.
int32_t pp_admit_shared(void* h, int32_t slot, const int32_t* shared,
                        int32_t n_shared, int32_t n_new) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (slot < 0 || slot >= pool->max_seqs || pool->active[slot]) return -1;
  if (n_shared < 0 || n_new < 0 ||
      n_shared + n_new > pool->max_pages_per_seq)
    return -1;
  for (int32_t i = 0; i < n_shared; ++i) {
    int32_t p = shared[i];
    if (p < 0 || p >= pool->total_pages || pool->refs[p] <= 0) return -1;
  }
  if (static_cast<int32_t>(pool->free_stack.size()) <
      n_new + pool->decode_reserve)
    return -1;
  auto& table = pool->tables[slot];
  table.clear();
  for (int32_t i = 0; i < n_shared; ++i) {
    table.push_back(shared[i]);
    ++pool->refs[shared[i]];
  }
  for (int32_t i = 0; i < n_new; ++i) table.push_back(pool->take_free());
  pool->active[slot] = 1;
  return 0;
}

// Prefix-cache retain: add one reference to a LIVE page so it survives its
// owning sequence. Returns the new count, or -1 (free/invalid page).
int32_t pp_retain(void* h, int32_t page) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (page < 0 || page >= pool->total_pages || pool->refs[page] <= 0)
    return -1;
  return ++pool->refs[page];
}

// Prefix-cache release (eviction): drop one reference; the page returns to
// the free pool at zero. Returns the new count, or -1.
int32_t pp_release(void* h, int32_t page) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (page < 0 || page >= pool->total_pages || pool->refs[page] <= 0)
    return -1;
  int32_t left = pool->refs[page] - 1;
  pool->drop_ref(page);
  return left;
}

int32_t pp_refcount(void* h, int32_t page) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (page < 0 || page >= pool->total_pages) return -1;
  return pool->refs[page];
}

// Grow an active sequence by one page (decode crossing a page boundary).
// Returns the new physical page id, or -1 if the pool is exhausted / the
// slot is at its page cap.
int32_t pp_extend(void* h, int32_t slot) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (slot < 0 || slot >= pool->max_seqs || !pool->active[slot]) return -1;
  auto& table = pool->tables[slot];
  if (static_cast<int32_t>(table.size()) >= pool->max_pages_per_seq) return -1;
  if (pool->free_stack.empty()) return -1;
  int32_t page = pool->take_free();
  table.push_back(page);
  return page;
}

// Release all of a slot's pages back to the pool.
void pp_free_seq(void* h, int32_t slot) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (slot < 0 || slot >= pool->max_seqs || !pool->active[slot]) return;
  for (int32_t p : pool->tables[slot]) pool->drop_ref(p);
  pool->tables[slot].clear();
  pool->active[slot] = 0;
}

// Restore a slot to an explicit page table (checkpoint resume). Free pages
// are claimed; pages already live (restored into another slot first —
// prefix-shared tables) gain a reference instead. Duplicates within one
// table are rejected; all-or-nothing like pp_admit. Bypasses the decode
// reservation: a restore reinstates state that was already admitted before
// the snapshot. Returns 0 on success, -1 otherwise.
int32_t pp_restore(void* h, int32_t slot, const int32_t* pages, int32_t n) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (slot < 0 || slot >= pool->max_seqs || pool->active[slot]) return -1;
  if (n < 0 || n > pool->max_pages_per_seq) return -1;
  std::vector<uint8_t> seen(pool->total_pages, 0);
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = pages[i];
    if (p < 0 || p >= pool->total_pages || seen[p]) return -1;
    seen[p] = 1;
  }
  // claim free pages / incref live ones; rebuild the free stack in one pass
  std::vector<int32_t> kept;
  kept.reserve(pool->free_stack.size());
  for (int32_t p : pool->free_stack)
    if (!seen[p]) kept.push_back(p);
  for (int32_t i = 0; i < n; ++i) ++pool->refs[pages[i]];
  pool->free_stack.swap(kept);
  pool->tables[slot].assign(pages, pages + n);
  pool->active[slot] = 1;
  return 0;
}

namespace {

// mutex must be held; returns 1 if the evicted entry's page went free
int32_t pc_evict_one(PagePool* pool) {
  if (pool->pc_lru.empty()) return -1;
  const PagePool::PcKey* key = pool->pc_lru.front();
  pool->pc_lru.pop_front();
  auto it = pool->pc_map.find(*key);
  if (it == pool->pc_map.end()) return 0;  // should not happen
  int32_t page = it->second.page;
  int32_t freed = pool->refs[page] == 1 ? 1 : 0;
  pool->drop_ref(page);
  pool->pc_map.erase(it);
  return freed;
}

}  // namespace

// Prefix-cache match: longest cached page chain covering a page-aligned
// prefix of `tokens` (always leaving >= 1 token for the tail prefill).
// Writes the page ids to `out` (capacity `cap`); returns the count and
// updates LRU order + hit stats.
// `anchor` scopes the chain root (< 0, distinct per namespace): prefix
// pages' K/V depend on the LoRA adapter that computed them, so each
// adapter content-addresses its own chains (base model = -1).
int32_t pp_pc_match(void* h, const int32_t* tokens, int32_t n,
                    int32_t page_size, int64_t anchor, int32_t* out,
                    int32_t cap) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (page_size <= 0 || n <= 0) return 0;
  int64_t parent = anchor;
  int32_t found = 0;
  int32_t max_full = (n - 1) / page_size;
  PagePool::PcKey key;
  for (int32_t i = 0; i < max_full && found < cap; ++i) {
    key.parent = parent;
    key.toks.assign(tokens + i * page_size, tokens + (i + 1) * page_size);
    auto it = pool->pc_map.find(key);
    if (it == pool->pc_map.end()) break;
    pool->pc_touch(it->second);
    out[found++] = it->second.page;
    parent = it->second.id;
  }
  if (found > 0) {
    ++pool->pc_hits;
    pool->pc_hit_tokens += static_cast<int64_t>(found) * page_size;
  } else {
    ++pool->pc_misses;
  }
  return found;
}

// Prefix-cache insert: index the full pages of `tokens`, backed by the
// slot's page-id `table` (npages entries, in order). Existing entries
// dedupe (the chain continues through the cached copy); each NEWLY
// indexed page gains one reference. LRU-evicts past `max_entries`.
void pp_pc_insert(void* h, const int32_t* tokens, int32_t n,
                  const int32_t* table, int32_t npages, int32_t page_size,
                  int32_t max_entries, int64_t anchor) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (page_size <= 0) return;
  int64_t parent = anchor;
  int32_t full = n / page_size;
  if (full > npages) full = npages;
  PagePool::PcKey key;
  for (int32_t i = 0; i < full; ++i) {
    key.parent = parent;
    key.toks.assign(tokens + i * page_size, tokens + (i + 1) * page_size);
    auto it = pool->pc_map.find(key);
    if (it != pool->pc_map.end()) {
      pool->pc_touch(it->second);
      parent = it->second.id;
      continue;
    }
    int32_t page = table[i];
    if (page < 0 || page >= pool->total_pages || pool->refs[page] <= 0)
      break;  // page not live — cannot index it
    ++pool->refs[page];
    int64_t id = ++pool->pc_next_id;
    // emplace first, then point the LRU node at the map-owned key
    // (unordered_map rehash never invalidates element references)
    auto ins = pool->pc_map.emplace(
        key, PagePool::PcEntry{page, id, pool->pc_lru.end()});
    pool->pc_lru.push_back(&ins.first->first);
    ins.first->second.lru_it = std::prev(pool->pc_lru.end());
    parent = id;
    while (static_cast<int32_t>(pool->pc_map.size()) > max_entries)
      pc_evict_one(pool);
  }
}

// Release the n least-recently-used entries; returns how many pages
// actually returned to the free pool.
int32_t pp_pc_evict(void* h, int32_t n) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  int32_t freed = 0;
  for (int32_t i = 0; i < n && !pool->pc_lru.empty(); ++i) {
    int32_t f = pc_evict_one(pool);
    if (f > 0) freed += f;
  }
  return freed;
}

int32_t pp_pc_len(void* h) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  return static_cast<int32_t>(pool->pc_map.size());
}

// out4: [hits, misses, hit_tokens, entries]
void pp_pc_stats(void* h, int64_t* out4) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  out4[0] = pool->pc_hits;
  out4[1] = pool->pc_misses;
  out4[2] = pool->pc_hit_tokens;
  out4[3] = static_cast<int64_t>(pool->pc_map.size());
}

int32_t pp_num_pages(void* h, int32_t slot) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (slot < 0 || slot >= pool->max_seqs) return -1;
  return static_cast<int32_t>(pool->tables[slot].size());
}

// Copy the slot's page table into `out` (caller-sized to cap). Returns the
// number of entries written.
int32_t pp_table(void* h, int32_t slot, int32_t* out, int32_t cap) {
  auto* pool = static_cast<PagePool*>(h);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (slot < 0 || slot >= pool->max_seqs) return -1;
  auto& table = pool->tables[slot];
  int32_t n = static_cast<int32_t>(table.size());
  if (n > cap) n = cap;
  std::memcpy(out, table.data(), n * sizeof(int32_t));
  return n;
}

}  // extern "C"
