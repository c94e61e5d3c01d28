// B2: paged decode attention for Hopper, sm_90a, with B3's append fused
// into its decode launch.
//
// Replaces tpu_flash/ops/paged.py:_paged_kernel (launched by
// paged_attention): one query token per lane attends its slot's pages,
// walked through the page table with an online base-2 softmax; with the
// new token's K/V (new_k, new_v) the walk first quantizes and writes them
// into the slot's tail page and attends them from registers, as the
// reference's fused append does. Also replaces
// tpu_flash/ops/paged.py:_pipe_kernel (launched by
// paged_attention_pipelined): its hand-pipelined DMA loop walks exactly the
// lane's own pages, which this walk does when pages_bound does not cap it,
// and its rank-1 append is the same function as the fused append.
//
// Each lane sees keys [start, len): len is lengths_override[lane] when
// given, else lengths[slot] + len_add; start is 0, or under a band
// (radius >= 0) max(qpos - radius, 0) with qpos = positions[lane] when
// given, else len - 1. The walk starts at page start / page and covers at
// most pages_bound pages (the wrapper caps it at the band's page count);
// a lane with no visible key (an empty chunk prefix, start >= len) gives
// o = 0 and lse = -inf, the weight-0 partial that merge_partials expects.
//
// Page types (paged_page.cuh, a code from the host, never read off the
// storage's byte width): float32, bf16, int8, int4 packed in halves (d/2
// bytes a row) and e4m3, the last three with a float32 scale a row.
//
// Numerics mirror the reference: q is prescaled by scale·log2(e) in
// float32 (q·qscale) and rounded to bf16 as it is loaded; K/V page values
// are cast to bf16 before the dots (exact for int8, int4 and e4m3 codes,
// which decode exactly; rounds float32 pages); scores accumulate in
// float32; quantized pages multiply the score column by the K scale and P
// by the V scale; P is rounded to bf16 against the running max after each
// page, before P·V; l sums the unscaled P; masked keys take
// DEFAULT_MASK_VALUE; o = acc·(1/l) only for rows with l > 0 and m >
// DEFAULT_MASK_VALUE/2, else 0 (lse = -inf). The fused append encodes the
// row with paged_page.cuh:encode_row, as paged_append.cu does. (The
// reference's kernel decodes e4m3 subnormals approximately, through
// tpu_flash/quant/flash_q.py:_fp8_upcast; here they decode exactly.)
//
// What bounds it on an H100: HBM bytes. Decode reads every visible K/V
// page once (16 lanes × ~540 tokens × 8 kv heads × d 128 is ~17 MB a layer
// for an int8 or fp8 cache, ~9 MB for int4, ~35 MB for bf16) at ~2 FLOP a
// byte: the ceiling is 3.35 TB/s and the tensor cores have nothing to do. The chunk prefix of
// chunked prefill is the exception: 512 lanes of ONE slot read the same
// ≤ 9 pages, so there the work is 512 q rows × the prefix, a small GEMM.
//
// Two routes (ops/paged.py:paged_route picks one from static shapes):
//
// - split (route 0), the decode route, any slots, with or without a band:
//   one CTA of 4 warps per (split, kv head, lane). A split is a run of at
//   most S consecutive pages of the lane's walk (S from the host's plan,
//   ops/paged.py:split_plan, which the plain version takes too); all of a
//   split's pages are in flight at once. Where the 1-D bulk copy takes a
//   page (each K and V page one contiguous run of (kvh, total, page, row)
//   storage whose page·row_bytes are a multiple of 16, scale rows of
//   4·page bytes likewise), two or four bulk copies a page fill an S-stage
//   shared ring; otherwise (float32 pages, which are staged as the bf16 the
//   dots read, so that a page of 128 at d 256 fits; quantized pages off
//   the 16-byte grid) every thread copies the split's pages with 8-byte
//   loads (4-byte ones where an int4 page is not a multiple of 8 bytes)
//   and the scale rows with 4-byte ones. int4 and e4m3 codes are decoded
//   where the dots load them (8 values at once, from the staged page). At a
//   d that is not a multiple of 8 the threads stage every page a unit at a
//   time into rows zero-padded to whole 8-column chunks (split_pitch); the
//   cache's layout is untouched. The launch refuses a plan
//   whose stages do not fit in shared memory (split_smem, the one account
//   of the layout). The dots run on the CUDA cores (decode has ~2 FLOP a
//   byte): LK lanes per key row (at most a warp), each holding one chunk of
//   8 columns (two above d 256) of the G query rows
//   of a chunk of at most 8 (2 above d 256; the rows of a kv head share every page read),
//   a shuffle sum per key; one warp per query row does the page's softmax;
//   P·V runs key row per lane group, and the groups' partial sums add in a
//   fixed order. A split writes float32 (m, l, acc) partials to the call's
//   workspace; the last CTA of a (lane, head) to finish, found by an atomic
//   ticket in that workspace (zeroed on the call's stream before the
//   launch, so two calls on two streams, or a captured graph beside an
//   eager call, never share one), combines them in split order, so one
//   launch does the call and two calls are bitwise equal. A (lane, head)
//   with one split writes o and lse itself. With new_k/new_v the CTA whose
//   split holds the tail page (or the walk's last split, when pages_bound
//   stops the walk before it) encodes the new row in registers, writes it
//   to the cache, and overwrites the stale row (and scale) of its staged
//   page once the copy has landed: each CTA merges its own registers, so
//   idle lanes that share the trash slot never read each other's row.
// - shared (route 1), the chunk prefix (shared_page_table: every lane on
//   one slot, one table row): a CTA takes 64 (lane, g) rows, lane-major, of
//   one kv head and walks the union of their visible pages, one 64-key page
//   a step, with per-row masks [start_r, end_r). Raw pages come in by bulk
//   copy into a 1–3 stage ring; the 4 warps decode them to bf16 in the
//   128-byte swizzled layout wgmma reads; S = Q·Kᵀ and O += P·V are bf16
//   wgmma (V read MN-major, P from registers), S/P/O in registers. The
//   running max advances one page a step and a row's keys outside its own
//   range take p = 0, so every row rounds P where its one-split walk does.
//   Page 64 only. At d above 256 (width 512) O's 256-column halves are the
//   grid's z axis, each CTA recomputing S over the full width, and the
//   pages decode from device memory straight into one tile pair: the Q and
//   tile pair take 160 KB, leaving no room for raw stages. At a d that is
//   not a multiple of 8 the decode reads element by element.
//
// Head dims: 1 to 512 (even for int4); the instantiations above 256 are
// compiled in paged_attention_wide.cu, beside this file's.

#include "paged_attention.cuh"

// q: (b, kvh, g, d) of q_dtype (0 float32, 1 bf16), unscaled: the kernel
// rounds q·qscale to bf16; new_k/new_v: (b, kvh, d) of in_dtype (0, 1) for
// the split route's fused append, else null; k/v pages: (kvh, total, page,
// row_units) of page_type (paged_page.cuh: 0 float32, 1 bf16, 2 int8, 3
// int4 in halves of d/2 bytes, 4 e4m3), written by the append, 8-byte
// aligned (16 on the shared route); scales: (kvh, total, page) f32 for the
// quantized types (2-4), else null; slots (b,), lengths (max_seqs,), page_tables
// (max_seqs, max_pages) int32; lengths_override and positions: (b,) int32
// or null; radius: the band radius, or -1 for none; d: 1 to 512 (even for
// int4 pages); g: any group size; out: (b, kvh, g, d) of out_dtype (0 float32,
// 1 bf16); lse: (b, kvh, g) float32 or null. route: 0 split (split_pages
// pages a split, n_splits = the grid's splits; when n_splits > 1, ws_acc
// (b, kvh, n_splits, g, d) and ws_ml (b, kvh, n_splits, g, 2) float32 and
// tickets (b, kvh) int32, which this call zeroes on `stream` before its
// launch), 1 shared (page 64; every lane on slots[0]'s table row). All
// contiguous. A route that does not take the shape, or a split plan whose
// stages do not fit in shared memory, returns cudaErrorInvalidValue.
extern "C" cudaError_t tf_paged_attention(
    const void* q, const void* new_k, const void* new_v, void* k_pages, void* v_pages,
    float* k_scales, float* v_scales, const int* slots, const int* lengths,
    const int* lengths_override, const int* positions, const int* page_tables, void* out,
    float* lse, float* ws_acc, float* ws_ml, int* tickets, int b, int kvh, int g, int d,
    int page, int total_pages, int max_pages, int pages_bound, int len_add, int radius,
    int q_dtype, int in_dtype, int page_type, int out_dtype, int route, int split_pages,
    int n_splits, float qscale, cudaStream_t stream) {
  if (b <= 0) return cudaSuccess;
  const bool quant = page_quantized(page_type);
  if (g < 1 || d < 1 || d > 512 || (page_type == PT_I4 && d % 2 != 0) || page < 1 ||
      page > MAX_PAGE ||
      max_pages < 1 || pages_bound < 1 || radius < -1 || q_dtype < 0 || q_dtype > 1 ||
      !page_type_ok(page_type) || route < SPLIT || route > SHARED ||
      quant != (k_scales != nullptr && v_scales != nullptr) ||
      (new_k != nullptr) != (new_v != nullptr) || (new_k != nullptr && route != SPLIT) ||
      (new_k != nullptr && (in_dtype < 0 || in_dtype > 1)) || b > 65535 || kvh > 65535 ||
      !aligned(k_pages, 8) || !aligned(v_pages, 8))
    return cudaErrorInvalidValue;
  // the bulk copies' rules: 16-byte sizes and addresses
  const bool bulk_ok = aligned(k_pages, 16) && aligned(v_pages, 16) &&
                       (!quant || (aligned(k_scales, 16) && aligned(v_scales, 16)));
  const bool bulk = page_type != PT_F32 && bulk_ok && d % 8 == 0 &&
                    ((size_t)page * row_bytes(page_type, d)) % 16 == 0 &&
                    (!quant || page % 4 == 0);
  if (route == SHARED && (page != SH_PAGE || !bulk_ok)) return cudaErrorInvalidValue;
  if (route == SPLIT &&
      (split_pages < 1 || n_splits < 1 || n_splits > 65535 ||
       (long)n_splits * split_pages < pages_bound ||
       (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr || tickets == nullptr))))
    return cudaErrorInvalidValue;
  if (route == SPLIT && n_splits > 1) {
    const cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(int) * (size_t)b * kvh, stream);
    if (err != cudaSuccess) return err;
  }
  const Args a{q, new_k, new_v, k_pages, v_pages, k_scales, v_scales, slots, lengths,
               lengths_override, positions, page_tables, out, lse, ws_acc, ws_ml, tickets,
               b, kvh, g, d, page, total_pages, max_pages, pages_bound, len_add, radius,
               q_dtype == 0, in_dtype == 0, split_pages, n_splits, bulk, qscale};
  if (d > 256) return tf_paged::launch_wide(page_type, out_dtype, route, a, stream);
  return by_out<false>(out_dtype, page_type, route, a, stream);
}
