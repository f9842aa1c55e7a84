// Attention with SAM's decomposed relative-position bias in f32 for Hopper
// (sm_90a): 3xTF32 on wgmma, warp-specialised. Two kernels:
//
// * flash_relpos_tf32_kernel replaces, for float32 inputs, the TPU kernel
//   beyondff_tpu/kernels/flash_attention.py flash_attention_relpos (:193,
//   pallas_call :214, body _relpos_kernel :128, wrapper attend_relpos :253):
//   softmax(Q K^T * scale + bias) V over a raster-ordered (kh, kw) key grid
//   with an online max and denominator, the output divided once. SAM
//   ViT-H's global blocks in detector.dtype float32 under
//   BFF_SAM_RELPOS_FLASH=1: (16 B, 4096, 80), and (16 B, 3072, 80) on the
//   rect 48 x 64 grid; and at head dim 64, the shape of SAM ViT-L's (16 B,
//   4096, 64) and ViT-B's (12 B, 4096, 64) global blocks, and at head dims
//   32, 48, 96, 112 and 128, which the public entry takes and no configured
//   model calls.
// * window_relpos_tf32_kernel replaces, for float32 inputs, the TPU kernel
//   beyondff_tpu/kernels/window_attention.py window_attention_relpos (:51,
//   pallas_call :110): the same function over G independent 14 x 14 windows
//   (S = 196). SAM ViT-H's windowed blocks: (25 * 16 B, 196, 80).
//
// bias[q, k] = bias_h[q, k / kw] + bias_w[q, k % kw], the factors in f32,
// added in f32. bff_flash_attention_relpos and bff_window_attention_relpos
// (csrc/relpos_attention.cu) route here exactly the calls that
// bff_relpos_tf32_takes accepts (kernels/flash_attention.py
// relpos_tf32_route mirrors it): f32, any kh >= kMinGridH with kw = 64, kw a
// multiple of 8 from kMinGridW = 8 to 56 (the narrow mode below) or any
// other kw from kMinStraddleW to 63 (the straddling mode), at the head dims
// of k4_dim, the multiples of 16 from 32 to 128 (K4; K5's windows past 256
// tokens too, G windows as BH), or a 14 x 14 window at D 80 (K5), a positive
// finite scale, and q, k, v, o and both factors 16-byte aligned; and those
// that bff_relpos_tf32_streamed_takes accepts (relpos_tf32_streamed_route):
// K4 at those head dims on grids wider than 64, any kh (the streamed mode).
// Every other f32 call keeps the FMA kernels of csrc/relpos_attention.cu:
// head dim 16, those that are no multiple of 16 and 136, and a pointer off
// 16 bytes. The line lies below every grid K4
// takes: at one grid row (16 heads, S = 64) this kernel took 0.0101 ms
// against the FMA kernel's 0.0211, at 2, 4 and 8 rows 2.5-3.5x less
// (tools/kernel_variants.py --cases "relpos_f32 small"), so kMinGridH is 1.
// The lines hold at every head dim K4 takes (the same tool, device time, 16
// heads, NVIDIA H100 80GB HBM3 at 700 W): on 1, 2, 4 and 8 rows of 64, 1 x
// 8, 8 x 8, 1 x 65 and kw 1-7 on 64 rows this kernel took 0.25-0.85 of the
// FMA kernel's time at D 32, 48, 112 and 128 (D 128: 1 x 64 0.0140 ms
// against 0.0282, 64 x 1 0.0158 against 0.0285; D 32: 1 x 8 0.0063 against
// 0.0075, the closest). At one tile of D 32 and 48 both calls take less
// than the host's launches: by events, back to back, 1 x 8 at D 32 took
// 0.0112 against 0.0089 (this route's two launches and scratch, 12 us a
// call on the host against 9), a cost of the call's host side, not of the
// kernel.
// No mode ties the grid's height to 64: bias_h is read from device memory
// by grid row, never tabled, and tile counts and offsets are ints of S (row
// offsets 64-bit), so taller grids, past kh + kw = 256 too, take the same
// kernels.
//
// Precision. As in csrc/flash_attention_tf32.cu: each f32 operand x is split
// into TF32 words hi = rna(x), lo = rna(x - hi) (cvt.rna.tf32.f32) and each
// product is summed as lo hi + hi lo + hi hi in f32 accumulators, about 22
// bits of each operand; one TF32 product would miss the 1e-4 the f32 calls
// are held to. Q is multiplied by the scale before it is split, so the
// scores come out in natural units and the bias is their accumulator's
// initial value: the wgmma chain of Q K^T starts from bias_w (K4) or the
// whole bias (K5), never from zero. The tensor cores' f32 sums lose more
// than the FMA units' round-to-nearest adds: with P V accumulated in the
// wgmma registers across all 64 key tiles of a row (1 536 products), K4 at
// (64, 4096, 80) lay 8.0e-5 from its plain version, against 9.3e-6 for
// the FMA kernel. So each tile's P V is a fresh wgmma sum (kFold), added
// to the output rows by the FMA units: 5.7e-6, for 3-5% of the time and 40
// registers.
//
// Bound on an H100 SXM (3xTF32: 495 / 3 = 165 TFLOP/s of f32-grade work;
// 3.35 TB/s): K4 at (64, 4096, 80) does 4 * 64 * 4096^2 * 80 = 3.44e11
// operations (2.082 ms) and moves q, k, v, o (84 MB each) and both factors
// (67 MB each), 470 MB (0.140 ms): bound by operations. K5 at (1600, 196,
// 80) moves 4 * 1600 * 196 * 80 * 4 + 2 * 1600 * 196 * 14 * 4 bytes = 436 MB
// (0.130 ms) against 4 * 1600 * 196^2 * 80 = 1.97e10 operations (0.119 ms):
// nearly balanced, bytes ahead.
//
// Shared-memory layout (both kernels). TF32 wgmma reads shared-memory
// operands K-major only (no transpose bit) and a k8 step is 32 bytes of a
// row, so every operand is stored as "images" of 32-byte rows in the 32-byte
// swizzle (the 16-byte half c of row r at half c ^ ((r / 4) % 2)): Q and K
// (rows x 80) as 10 regions of rows x 32 bytes, region kk holding columns 8
// kk .. 8 kk + 7, read by k-step kk of Q K^T; V^T (80 x keys) as one region
// of 80 x 32 bytes per 8-key group, read by k-step kk of P V with N = 80
// (wgmma.m64n80k8). A row of 80 floats is 320 bytes, which no single
// 128-byte swizzle box covers; the 32-byte swizzle covers it in ten uniform
// regions. Each 8-key group of V^T stores its keys in the order 0 2 4 6 1 3
// 5 7 (kernels/flash_attention.py TF32_KEY_ORDER), so P's accumulator
// registers are its A fragments as they stand (csrc/flash_attention_tf32.cu
// explains the permutation).
//
// Where a lane's values lie (kernels/flash_attention.py relpos_tf32_fragment
// mirrors this, and the CPU tests hold it to relpos_bias): score register 4
// j + e of lane l in warp w of a consumer warpgroup holds row 16 w + l / 4 +
// 8 (e / 2) and column 8 j + 2 (l % 4) + e % 2 of the m64nN tile.
//
// K4 design (grid (ceil(S / 128), BH), one block of three warpgroups a SM):
// * A pre-pass (split_kv_relpos_kernel, one block a 64-key tile of a head)
//   writes each tile's K hi, K lo, V^T hi and V^T lo images, ready to copy,
//   into scratch the wrapper allocates (4 BH S 80 floats; S = 64 kh is whole
//   tiles). It reads k and v once (168 MB at (64, 4096, 80)) and writes them
//   twice (336 MB).
// * Warpgroup 2 is the producer: one thread copies each tile's K images
//   (40 KB) and V^T images (40 KB) with one bulk copy each into a single
//   K stage and a single V stage, with a full and an empty mbarrier each.
// * Warpgroups 0 and 1 are the consumers, 64 query rows each: Q scaled,
//   split once into its images in shared memory (80 KB for both); S = Q K^T
//   by 30 wgmma.m64n64k8 from shared memory, P V by 24 wgmma.m64n80k8 with
//   P split in registers. Tile t's Q K^T is issued after tile t - 1's P V
//   has finished, and the consumers take turns to issue Q K^T (pingpong).
//   Issuing it before (kOverlap, csrc/flash_attention_tf32.cu's order)
//   keeps scores, P's halves and the output live at once and spills: 4.76
//   against 3.30 ms at (64, 4096, 80).
// * With kw = 64 a 64-key tile is one grid row: bias_w[q, kx] is the same
//   for every tile. The block's 128 rows of it sit in a shared-memory table
//   (row stride 72 floats: a warp's 8-byte reads fall in distinct banks),
//   from which each tile's score accumulators are initialised; bias_h[q, t]
//   stays out of the scores and shifts the row's max and exponent once a
//   tile, read from device memory (L1).
// * Shared memory: Q images 80 KB, one K and one V stage 80 KB, the bias_w
//   table 36 KB: 197 KB. Two stages (another 80 KB) do not fit beside the
//   table. ptxas holds the 384-thread block to 168 registers: scores 32,
//   the output 40, P's halves 64 and, with kFold, the tile's P V 40; 72
//   bytes spill (155 registers and none without kFold).
// * Rows past S (an odd kh) are computed on zero Q and not written.
// * Grids narrower than 64 (the narrow mode, flash_relpos_tf32_kernel<D,
//   true>: SAM's portrait frames under BFF_SAM_RECT=1, 64 x 32 for a 2:1
//   frame). A 64-key tile then spans 64 / kw grid rows or, where kw does
//   not divide 64, parts of two or more, so neither factor is the same for
//   every tile. The tiles stay 64 keys (the wgmma shapes, stages, pingpong
//   and fold of the wide mode, at full tensor-core width whatever kw is);
//   what changes is where the bias comes from. With kw a multiple of 8 an
//   n8 group of keys lies in one grid row, so the wide mode's split holds
//   a group at a time: each score's accumulator starts at bias_w[q, k % kw]
//   (an 8-byte pair a lane from the block's table: kw columns at a row
//   stride of kw or kw + 8, whichever is 8 mod 16 in 8-byte words, no bank
//   conflicts), and bias_h[q, k / kw] shifts the group's logits in log2
//   units in the softmax (16 shifts a lane a tile, read from device
//   memory, L1); the group's grid row and column advance by 8 keys a group
//   and 64 a tile without a division. The pre-pass pads the last tile (S =
//   kh kw need not be a multiple of 64) with zero keys, which start at
//   -inf. Two designs lost (tools/kernel_variants.py on an H100 at 700 W):
//   the whole bias as the accumulators' start, as K5 does, lay 1.07e-4
//   from plain at factor scale 3 (the tensor cores' sums carry twice a
//   factor's magnitude through every k-step); the whole bias added in f32
//   once the products are in held 1e-4 but its reads sit between the
//   scores and the softmax, 6-19% slower. The
//   other way, tiles of one grid row (N = kw), keeps the wide mode's row
//   shift but runs the tensor cores at n16..n56 with the per-tile softmax
//   and barrier costs of a 64-key tile.
// * Grids narrower than 64 whose width is no multiple of 8 (the straddling
//   mode, flash_relpos_tf32_kernel<D, kStraddleMode>): an n8 group of keys
//   then straddles two grid rows, or below kw = 8 several, so bias_h can no
//   longer be one shift a group. The tiles, stages, pingpong and fold stay
//   the narrow mode's; the scores' products are summed from zero and each
//   score's whole bias, bias_h[q, key / kw] + bias_w[q, key % kw] of its own
//   key, is added in f32 once they are in (kBiasAfter, the reads issued
//   while the products run), with no row shift. A lane's (ky, kx) comes
//   from one division a tile and steps of 8 keys (one wrap at kw >= 8, a
//   division below), the pair's second key the next column or the next
//   row's first. bias_w is read float by float (an odd kw's pairs are not
//   8-byte aligned) from a table at straddle_ld's stride, 3 mod 16 floats,
//   where a warp's 32 reads meet at most two to a bank (at the stride kw up
//   to four); at D 96 its widest rows (67 floats) grow the table's room from
//   64 floats a row, which still fits.
// * Grids wider than 64 (the streamed mode, flash_relpos_tf32_kernel<D,
//   kStreamMode>: SAM past a 1024-pixel side, 1 x 300 or 2 x 255 past kh +
//   kw = 256). A block's 128 rows of bias_w no longer fit beside Q's images
//   and the stages (128 x 255 floats are 130 KB), so the table goes: a
//   64-key tile lies in at most two grid rows (kw > 64) and its bias_w
//   columns are one run of 64 from (64 t) % kw that wraps at most once.
//   The producer warpgroup's three idle warps copy that run for the block's
//   128 rows into a slot of the tile's K stage (128 x 64 floats, 32 KB, in
//   the table's room; two at D 64's two K stages, which grow it) by 4-byte
//   cp.async, a row's 32 columns a copy step (the factors need no alignment
//   past 4 bytes, and a run starts at any column), and arrive on the
//   stage's full barrier when their copies are in
//   (cp.async.mbarrier.arrive.noinc): the stage is full with its K images
//   and its slot, and the consumers' release of it after their products
//   releases the slot too, so the slot adds no barrier and no wait to
//   either consumer. The slot's 8-column groups are swizzled by row (group
//   g of row r at g ^ (r % 8)): a quad's 8-byte reads of 8 rows fill each
//   bank twice. bias_h is two reads a row a tile (grid rows ky and ky + 1).
//   The tiles, stages, pingpong and fold are the narrow mode's, and as in
//   the straddling mode the products are summed from zero and each score's
//   whole bias added in f32 once they are in, read while the products run.
//   Each tile's P V is added to the output as soon as it is in (FoldFirst:
//   the same sums in the same order), so its 40 registers are not live
//   beside the scores and the bias. The other plan, each score reading its
//   bias_w from device memory (kBwStreamed false), is
//   tools/kernel_variants.py's k4_tf32_bw_from_l2: on an H100 at 700 W (one
//   process, CUDA events) 5.877 ms at (16, 8192, 80) on 64 x 128 against
//   the slot's 5.323, 2.292 against 2.140 on 72 x 72, 7.954 against 7.377
//   at (4, 18 496, 80) on 136 x 136, 2.799 against 2.412 at head dim 96,
//   level at 2 x 255 and 1 x 300 (0.0372 / 0.0378, 0.0275 / 0.0274); it
//   spills 496 bytes at head dim 80. A first slot, copied by each consumer
//   warp for its own rows between the products' issue and their wait,
//   spilled 560 bytes and lost to both (6.527 at 64 x 128). ptxas: the
//   streamed mode spills 0, 120 and 132 bytes at head dims 64, 80 and 96
//   (168 registers).
// * Head dim 64 (K4Cfg<64>): images of 16 KB a 64-key tile, 8 regions a
//   row. Q 64 KB, two K stages and one V stage 96 KB and the table 36 KB:
//   196 KB. Two V stages as well fit only with the table at 64 floats a
//   row (its 8-column groups swizzled against bank conflicts) and were
//   1.4% slower at (64, 4096, 64) than one; one K stage 3.3% slower
//   (tools/kernel_variants.py). The consumers hold the output 32, scores
//   32, P's halves 64 and the fold's 32 registers: no spill.
// * Head dim 96 (K4Cfg<96>, both modes): images of 24 KB a 64-key tile, 12
//   regions a row; Q 96 KB, one K and one V stage 96 KB. The wide mode's
//   bias_w table at 72 floats a row (36 KB) would pass the 227 KB, so at D
//   96 it is 64 floats a row with 8-column group j of row r stored at j ^ (r
//   % 8) (kBwSwizzled; a quad's 8-byte reads of 8 rows still fill each bank
//   twice): 229 376 bytes and the barriers. The narrow mode's table (kw <=
//   56 at a stride of at most 56) fits in the same room. The output at
//   m64n96 is 48 registers, the scores 32, P's halves 64, so the fold runs
//   in two 48-column parts (kFoldParts96, wgmma.m64n48k8, 24 registers),
//   each added as soon as it is in. And the scores are summed from zero,
//   bias_w added in f32 once they are in (kBiasAfter96; its table reads,
//   and the narrow mode's bias_h reads, issued while the products run):
//   started at bias_w, as at D 64 and 80, the tensor cores' f32 sums carry
//   the factors' magnitude through 36 k-steps, and at factor scale 3 K4 lay
//   1.33e-4 from plain (3.5e-5 and 4.1e-5 this way, at 64 x 32 and 64 x 64).
//   The pre-pass reads K's and V's tiles in turn into one buffer (both at
//   once would pass the 48 KB of static shared memory). ptxas: 168
//   registers, 108 bytes spilled in the wide mode and 168 in the narrow one
//   (the bias at the start: 100 and 152; the fold in one part: 180 and 268;
//   no fold: none and 88).
// * Head dims 112 and 128 (K4Cfg<112>, <128>, every mode). A 64-key stage
//   of K and V^T, hi and lo, is 112 or 128 KB, and both consumers' Q images
//   as much again: past the 227 KB. So the tiles are 32 keys (kBN128, as
//   csrc/flash_attention_tf32.cu's Cfg<128>): S = Q K^T by 3 D / 8
//   wgmma.m64n32k8, one K and one V stage, and still two 64-row consumers,
//   so a block's re-reads of the K and V images per query row stay those
//   of the 64-key design (64-row blocks would double them). At D 128: Q 128
//   KB, the stages 64 KB, the table's room 34 304 bytes (the straddling
//   mode's 67 floats a row; the wide mode's table 64 floats a row,
//   swizzled as at 96): 232 000 bytes with the barriers and the alignment.
//   At 112 the wide table keeps 72-float rows (209 984 bytes). What a
//   32-key tile changes: in the wide mode a tile is half a grid row
//   (bias_w's columns from 32 (t % 2), bias_h[q, t / 2] still one shift a
//   tile); in the narrow mode an n8 group still lies in one grid row; the
//   straddling mode adds each score's whole bias after the products as
//   before; in the streamed mode a tile lies in at most two grid rows and
//   its slot is 128 x 32 floats (group g of row r at g ^ (r % 4)), one copy
//   step a row. The pre-pass writes 32-key tiles into scratch rounded up to
//   32 keys. Registers (168): the output 64 (56 at 112), the scores 16,
//   their bias 16, P's halves 32, a fold part 16 at 128 (four parts,
//   m64n32k8) and 28 at 112 (two, m64n56k8); ptxas spills 112, 192, 184
//   and 136 bytes at D 128 in the wide, narrow, straddling and streamed
//   modes (two parts of 64: 160, 240, 200 and 184, and 4-15% slower,
//   k4_tf32_d128_fold_2), 24, 144, 104 and 72 at 112. The products run from zero and the bias is added
//   after them (kBiasAfter128): started at bias_w (the variant
//   k4_tf32_d128_bias_start) K4 lay 1.44e-4 and 1.51e-4 from plain at
//   factor scale 3 at D 128 and 112 (4.3e-5 and 3.4e-5 this way). The other
//   plan, the wide 3xTF32 kernel of csrc/relpos_attention_wide_tf32.cu at a
//   padded DP of 128 (one 64-row consumer, k4_tf32_plan_b), took 3.802 ms
//   at (16, 4096, 128) on 64 x 64 against this kernel's 1.864
//   (tools/kernel_variants.py on an H100 at 700 W, one process).
// * Head dims 32 and 48 (K4Cfg<32>, <48>): images of 8 and 12 KB a 64-key
//   tile, D / 8 = 4 and 6 regions a row, P V by wgmma.m64n32k8 and
//   m64n48k8. Two K and two V stages fit beside the table (136 256 and
//   185 408 bytes); one V stage was within 2.3% either way, one of each up
//   to 20% slower in the streamed mode (k4_tf32_d32_stages_*). The bias is the
//   scores' start, as at 64 and 80: 4.0e-5 and 6.8e-5 from plain at factor
//   scale 3. No spill. At these head dims the softmax's ex2 weighs most
//   against the products: 16 heads at S 4096 are 2.7e8 ex2 (0.064 ms at
//   the SFUs' 4.2e12 a second) against 0.208 ms of products at D 32.
//
// K5 design (a persistent grid of one block a SM, each walking items g * 2
// + round, the 128 query rows 128 round .. of window g):
// * No pre-pass: the producer warpgroup's 128 threads read each 40-key tile
//   of the window's K and V from device memory, split them and write their
//   images (keys >= 196 as zero) into a ring of two stages (50 KB each),
//   then fence.proxy.async and arrive on the stage's full barrier. A global
//   pre-pass would move 600 MB more than the kernel's 436 MB. The split is
//   done once per round, twice a window: the window's split K and V^T (256
//   KB) do not fit beside the queries' images. Reading tile u + 1 before
//   writing tile u (kWPrefetch) holds both tiles in registers and spills
//   more: 0.481 against 0.471 ms at (1600, 196, 80).
// * Each consumer reads its 64 rows of Q (all its loads issued before the
//   first split), scales and splits them, and copies its rows of the two
//   factor tables (196 x 14 each) into shared memory, once a round. Five
//   40-key tiles (keys 0..199, 196..199 masked by -inf in the
//   accumulator's initial value) with the same online softmax and pingpong
//   as K4, each tile's products in turn (the overlap spills: 0.520 against
//   0.471 ms); the initial value of each score is bias_h[q, k / 14] +
//   bias_w[q, k % 14] from the tables (a lane's key pair shares one grid
//   row: one bias_h read and one 8-byte bias_w read).
// * The 196 rows are 256 in four m-tiles (the last holds 4), the 196 keys
//   200: 1.33 times the window's operations reach the tensor cores.
//
// Measured on an H100 SXM at 700 W (tools/kernel_variants.py --cases
// relpos_f32, device time, one process): K4 at (64, 4096, 80) 3.30 ms (63%
// of the bound, the pre-pass 0.173 of it) against 20.75 ms for the FMA
// kernel and 13.35 ms for scaled_dot_product_attention in f32 with the
// bias as a float mask; K5 at (1600, 196, 80) 0.471 ms (28% of its byte
// bound) against 1.93 and 1.57 ms; K4 at (64, 4096, 64) 2.60 ms (64% of
// its 1.666 ms bound) against 13.86 and 8.24 ms. The narrow mode at (64,
// 2048, 64) on a 64 x 32 grid 0.909 ms (46% of its 0.4165 ms bound)
// against 4.46 ms for the FMA kernel and 2.63 ms for SDPA in f32 with the
// bias as a float mask; (64, 3072, 64) on 64 x 48 1.95 against 9.93 and
// 5.76; at head dim 80 1.18 and 2.52 against 5.31 / 11.71 and 3.39 / 7.60
// (D 80 spills 88 bytes; starting the scores at the whole bias, 16
// registers fewer, took 1.02 and 2.18 but missed 1e-4).
// At one tile (16 heads of a 1 x 8 grid) 0.0081 against the FMA kernel's
// 0.0119, so kMinGridW is 8, the narrowest width the groups allow.
// K4 at head dim 96 (NVIDIA H100 80GB HBM3, 700.00 W, CUDA events, one
// process): (64, 2048, 96) on 64 x 32 1.512 ms (41% of its 0.6247 ms
// bound, the pre-pass 0.105) against 10.27 ms for the FMA kernel and 3.359
// ms for SDPA in f32 with the bias as a float mask; 64 x 48 3.267 against
// 22.91 and 7.583; 64 x 64 4.255 (59% of 2.499) against 39.94 and 13.37. In
// another process the bias as the start took 1.361, 2.911 and 4.211 (10-11%
// less in the narrow mode, 1.5% in the wide one) and no fold 1.423, 3.068
// and 4.156 (4.5e-5 from plain at unit scale on 64 x 64, against 5.7e-6).
//
// Host: a failed launch returns non-zero and the wrapper raises: nothing
// falls back to another kernel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>

#include "attention_tc.cuh"
#include "tf32_images.cuh"

namespace {

using namespace bff_tf32;

constexpr int kD = 80;                // SAM ViT-H's head dim (K5's; K4 also takes 64)
constexpr int kConsumers = 2;         // consumer warpgroups of 64 query rows each
constexpr int kBM = 64 * kConsumers;  // query rows of a block (of a K5 round)
constexpr int kThreads = 128 * (kConsumers + 1);  // the producer is the last warpgroup
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr bool kPingpong = true;      // the consumers take turns to issue their products
constexpr bool kFold = true;          // each tile's P V summed apart, then added in f32
constexpr float kL2e = bff_tc::kLog2e;

// K4
constexpr int kGridW = 64;            // the key grid's width (kw) of the wide mode
constexpr int kMinGridH = 1;          // the smallest grid height (kh) K4 takes; any larger one
constexpr int kBN = 64;               // keys of a K4 tile: one grid row
constexpr bool kOverlap = false;      // issue Q K^T of tile t before P V of tile t - 1
constexpr int kKStages = 1, kVStages = 1;
constexpr int kBwLd = kGridW + 8;     // the bias_w table's row stride (floats)
constexpr int kMinGridW = 8;          // the narrow mode's smallest kw (a multiple of 8)
constexpr int kMinStraddleW = 1;      // the straddling mode's smallest kw (not a multiple of 8)
// the modes of flash_relpos_tf32_kernel: kw = 64, kw < 64 a multiple of 8
// (an n8 group of keys in one grid row), any other kw < 64 (groups straddle
// rows), kw > 64 (bias_w streamed a tile at a time: no block-wide table)
enum K4Mode { kWideMode, kNarrowMode, kStraddleMode, kStreamMode };
// the streamed mode: the producer warpgroup's other three warps copy each
// tile's bias_w run into a shared-memory slot of its K stage by 4-byte
// cp.async (false: each score reads its bias_w from device memory)
constexpr bool kBwStreamed = true;
constexpr int kFillThreads = 96;      // the slot's copiers: producer warps 1-3
// K4 at head dim 64 (K4Cfg): the K and V rings' depths
constexpr int kKStages64 = 2, kVStages64 = 1;
// K4 at head dim 96 (K4Cfg): each tile's P V summed apart in kFoldParts96
// column parts (m64n48k8 at 2), each added to the output rows in f32 as soon
// as it is in; one K and one V stage; at kw = 64 the bias_w table 64 floats
// a row with its 8-column groups swizzled (72-float rows do not fit)
constexpr bool kFold96 = true;
constexpr int kFoldParts96 = 2;
// and the scores' products summed from zero, the bias added in f32 once
// they are in (its table reads issued while the products run): started at
// bias_w, the tensor cores' sums carry its magnitude through 36 k-steps
constexpr bool kBiasAfter96 = true;
// K4 at head dims 112 and 128 (K4Cfg): 32-key tiles (64-key stages and Q's
// images pass the block's shared memory), one K and one V stage, each
// tile's P V summed apart in column parts (two of 56 at 112, four of 32 at
// 128), the bias added in f32 after the products, as at 96
constexpr int kBN128 = 32;
// the keys of a K4 tile at head dim D: K4Cfg<D>::kBN and the scratch's padding
__host__ __device__ constexpr int k4_tile(int D) { return D > 96 ? kBN128 : kBN; }
constexpr int kFoldParts112 = 2, kFoldParts128 = 4;
constexpr bool kBiasAfter128 = true;
// K4 at head dims 32 and 48 (K4Cfg): the K and V rings' depths
constexpr int kKStages32 = 2, kVStages32 = 2;
// the head dims K4's kernel takes: the multiples of 16 in [kMinK4D, kMaxK4D]
constexpr int kMinK4D = 32, kMaxK4D = 128;
constexpr int kSplitThreads = 256;

// K5
constexpr int kWin = 14;              // the window's side
constexpr int kWinS = kWin * kWin;    // its tokens: 196
constexpr int kWBN = 40;              // keys of a K5 tile
constexpr int kWTiles = 5;            // keys 0..199
constexpr int kWStages = 2;
constexpr int kWRounds = 2;           // 128-row rounds of a window: rows 0..255
constexpr bool kWOverlap = false;     // as kOverlap, for K5
constexpr bool kWPrefetch = false;    // the producer reads tile u + 1 before writing tile u

// The bytes of a K-like image of ``rows`` rows (D / 8 regions of rows x 32
// bytes) and of a V^T image of ``keys`` keys (keys / 8 regions of D x 32):
// both 4 D bytes a row or key.
template <int D = kD>
__host__ __device__ constexpr int img_bytes(int rows) { return rows * D * 4; }

struct Barriers {
  uint64_t k_full[2], k_empty[2], v_full[2], v_empty[2];
};

__device__ __forceinline__ uint64_t desc(uint32_t addr) { return sw32_desc(addr, 16); }

// S += Q K^T for the warpgroup's 64 rows (Q's images at qhi, qlo) and the N
// keys of a tile (K's images at khi, klo), head dim D (D / 8 regions): the
// small terms over every k-step first, then hi hi.
template <int N, int D>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], uint32_t qhi, uint32_t qlo,
                                             uint32_t khi, uint32_t klo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    mma_ss(s, desc(qlo + kk * 64 * 32), desc(khi + kk * N * 32));
    mma_ss(s, desc(qhi + kk * 64 * 32), desc(klo + kk * N * 32));
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_ss(s, desc(qhi + kk * 64 * 32), desc(khi + kk * N * 32));
}

// O += P V for the KS 8-key groups of a tile (V^T's images at vhi, vlo, a
// region of D x 32 bytes a group) and the 2 R columns of V^T's rows from
// vhi, vlo on (all D, or a part); O = P V when ``fresh``.
template <int KS, int D, int R>
__device__ __forceinline__ void issue_pv(float (&o)[R], const uint32_t (&ph)[KS][4],
                                         const uint32_t (&pl)[KS][4], uint32_t vhi,
                                         uint32_t vlo, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    mma_rs(o, pl[kk], desc(vhi + kk * D * 32), kk == 0 && fresh ? 0 : 1);
    mma_rs(o, ph[kk], desc(vlo + kk * D * 32));
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs(o, ph[kk], desc(vhi + kk * D * 32));
}

// The online softmax of one score tile in place. s holds the logits in
// natural units (masked keys at -inf); sh[h][g] shifts row h's logits in
// log2 units: with G = 1 the whole row (K4's wide mode: bias_h of the
// tile's grid row; K5: 0), with G = N / 8 the keys of n8 group g (K4's
// narrow mode: bias_h of the group's grid row). The running max m (log2
// units) is raised, l rescaled and summed, s turned into p; corr: the
// factors the output rows are rescaled by.
template <int N, int G>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const float (&sh)[2][G]) {
  static_assert(G == 1 || G == N / 8, "a shift a row, or a row and n8 group");
  float mx[2] = {bff_tc::masked_score(), bff_tc::masked_score()};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float m0 = fmaxf(s[4 * j], s[4 * j + 1]), m1 = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    mx[0] = fmaxf(mx[0], G == 1 ? m0 : fmaf(m0, kL2e, sh[0][j % G]));
    mx[1] = fmaxf(mx[1], G == 1 ? m1 : fmaf(m1, kL2e, sh[1][j % G]));
  }
  float c[2][G];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], G == 1 ? fmaf(mx[h], kL2e, sh[h][0]) : mx[h]);
    corr[h] = bff_tc::exp2_approx(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
#pragma unroll
    for (int g = 0; g < G; ++g) c[h][g] = sh[h][g] - m[h];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = bff_tc::exp2_approx(fmaf(s[4 * j], kL2e, c[0][j % G]));
    s[4 * j + 1] = bff_tc::exp2_approx(fmaf(s[4 * j + 1], kL2e, c[0][j % G]));
    s[4 * j + 2] = bff_tc::exp2_approx(fmaf(s[4 * j + 2], kL2e, c[1][j % G]));
    s[4 * j + 3] = bff_tc::exp2_approx(fmaf(s[4 * j + 3], kL2e, c[1][j % G]));
    l[0] += s[4 * j] + s[4 * j + 1];
    l[1] += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P split into the A fragments of the k-steps of P V: k-step kk takes the
// accumulator's n8 tile kk, column t of the fragment from key 2 t and
// column t + 4 from key 2 t + 1 (V^T's keys are stored in that order).
template <int KS>
__device__ __forceinline__ void split_p(uint32_t (&ph)[KS][4], uint32_t (&pl)[KS][4],
                                        const float (&s)[4 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    split_tf32(s[4 * kk], ph[kk][0], pl[kk][0]);
    split_tf32(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
    split_tf32(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
    split_tf32(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// The consumers' view of the K and V rings: K stage st's hi image at k_base
// + st * 2 img_bytes(N) and its lo image after it; V^T likewise.
struct Ring {
  Barriers* bars;
  uint32_t k_base, v_base;
};

// One warpgroup's pass over ``n_tiles`` key tiles of N keys against its 64
// query rows (Q's images at qhi, qlo), the tiles being the ring's u0 .. u0
// + n_tiles - 1 (stage u % stages, parity (u / stages) % 2). init(t, s, sh)
// sets tile t's score accumulators to their initial values (the bias, -inf
// for masked keys) and the log2 shifts of the rows (G = 1) or of each row's
// n8 groups (G = N / 8). Leaves the output rows (unnormalised) in acc and
// their denominators, summed over the quad, in l.
// With Fold each tile's P V is a fresh wgmma sum, added to acc by the FMA
// units: the tensor cores' f32 sums then span 3 KS products, not the row's
// every key. Parts > 1 splits that sum into column parts of D / Parts (its
// registers), each issued, waited for and added in turn (a whole tile's sum
// is added after the next tile's softmax; with FoldFirst as soon as it is in,
// the same sums in the same order, so that the scores' and the bias's
// registers are not live beside it). With BiasAfter init writes the initial
// values into registers of their own while the products run, the products
// are summed from zero and those values added in f32 once they are in.
// Every round of issues is one pingpong turn: consumer 1 hands consumer 0
// the first turn before the first pass, consumer 0 takes the surplus one
// after the last.
template <int N, int KStages, int VStages, bool Overlap, int D, int G, bool Fold, int Parts,
          bool BiasAfter, bool FoldFirst = false, typename Init>
__device__ __forceinline__ void attend_rows(float (&acc)[D / 2], float (&l)[2], uint32_t qhi,
                                            uint32_t qlo, const Ring& ring, int u0, int n_tiles,
                                            int wg, Init&& init) {
  constexpr int KS = N / 8;
  constexpr int kImg = img_bytes<D>(N);
  constexpr int R = D / 2 / Parts;  // the registers of one part of a tile's P V
  static_assert(Parts == 1 || (Fold && !Overlap), "parts of a fold, each tile's products in turn");
  static_assert(!(BiasAfter && Overlap), "the bias after the products, each tile's in turn");
  static_assert(!FoldFirst || (Fold && !Overlap), "a fold, each tile's products in turn");
  constexpr bool kFoldNow = Parts > 1 || FoldFirst;  // each part as soon as it is in
  Barriers* bars = ring.bars;
  const bool signals = (threadIdx.x & 31) == 0;  // one arrival per consumer warp
  const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kConsumers;
  auto k_hi = [&](int st) { return ring.k_base + st * 2 * kImg; };
  auto v_hi = [&](int st) { return ring.v_base + st * 2 * kImg; };
  float s[N / 2], pv_sum[Fold ? R : 1], bias[BiasAfter ? N / 2 : 1];
  uint32_t ph[KS][4] = {}, pl[KS][4] = {};
  float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, corr[2], sh[2][G];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (Fold ? R : 1); ++i) pv_sum[i] = 0.f;
  l[0] = l[1] = 0.f;
  // part ``part`` of the last tile's P V into acc
  auto fold = [&](int part) {
    if constexpr (Fold) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[part * R + i] += pv_sum[i];
    }
  };
  auto fence_pv = [&]() {
    if constexpr (Fold) fence_regs(pv_sum);
    else fence_regs(acc);
  };
  auto fence_for_issue = [&]() {
    fence_regs(acc);
    if constexpr (Fold) fence_regs(pv_sum);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(s);
    wgmma_fence();
  };
  // issues part ``part`` of the P V of the tile in V stage st: into acc, or
  // with Fold into pv_sum afresh
  auto issue_tile_pv = [&](int st, int part) {
    const uint32_t vh = v_hi(st) + part * (D / Parts) * 32;
    if constexpr (Fold) issue_pv<KS, D>(pv_sum, ph, pl, vh, vh + kImg, true);
    else issue_pv<KS, D>(acc, ph, pl, vh, vh + kImg, false);
  };
  auto turn = [&]() {
    if (kPingpong) turn_sync(my_turn);
  };
  auto hand_on = [&]() {
    if (kPingpong) turn_arrive(next_turn);
  };
  // tile t's scores (K stage st) in s, then its softmax
  auto scores = [&](int t, int st, int parity) {
    if constexpr (BiasAfter) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
    } else {
      init(t, s, sh);
    }
    bar_wait_or_trap(&bars->k_full[st], parity);
    turn();
    fence_for_issue();
    issue_scores<N, D>(s, qhi, qlo, k_hi(st), k_hi(st) + kImg);
    wgmma_commit();
    hand_on();
    if constexpr (BiasAfter) init(t, bias, sh);
    wgmma_wait<0>();
    fence_regs(s);
    if (signals) bar_arrive(&bars->k_empty[st]);
    if constexpr (BiasAfter) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) s[i] += bias[i];
    }
    softmax_tile<N, G>(s, m, l, corr, sh);
  };

  // tile 0: scores, softmax, P
  scores(0, u0 % KStages, (u0 / KStages) & 1);
  split_p<KS>(ph, pl, s);
  for (int t = 1; t < n_tiles; ++t) {
    const int u = u0 + t;
    const int st = u % KStages, parity = (u / KStages) & 1;
    const int pst = (u - 1) % VStages, pparity = ((u - 1) / VStages) & 1;
    if constexpr (Overlap) {
      init(t, s, sh);
      bar_wait_or_trap(&bars->k_full[st], parity);
      bar_wait_or_trap(&bars->v_full[pst], pparity);
      turn();
      fence_for_issue();
      issue_scores<N, D>(s, qhi, qlo, k_hi(st), k_hi(st) + kImg);
      wgmma_commit();
      issue_tile_pv(pst, 0);
      wgmma_commit();
      hand_on();
      wgmma_wait<1>();  // the scores are in
      fence_regs(s);
      if (signals) bar_arrive(&bars->k_empty[st]);
      softmax_tile<N, G>(s, m, l, corr, sh);
      wgmma_wait<0>();  // P V of tile t - 1 is in
      fence_pv();
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(s);
      if (signals) bar_arrive(&bars->v_empty[pst]);
    } else {
      bar_wait_or_trap(&bars->v_full[pst], pparity);
#pragma unroll
      for (int part = 0; part < Parts; ++part) {
        fence_for_issue();
        issue_tile_pv(pst, part);
        wgmma_commit();
        wgmma_wait<0>();
        fence_pv();
        fence_regs(ph);
        fence_regs(pl);
        if (kFoldNow) fold(part);
      }
      if (signals) bar_arrive(&bars->v_empty[pst]);
      scores(t, st, parity);
    }
    if (!kFoldNow) fold(0);
    rescale<D>(acc, corr);
    split_p<KS>(ph, pl, s);
  }
  // P V of the last tile (its own turn when the products overlap)
  const int lu = u0 + n_tiles - 1;
  const int lst = lu % VStages, lparity = (lu / VStages) & 1;
  bar_wait_or_trap(&bars->v_full[lst], lparity);
  if (Overlap) turn();
#pragma unroll
  for (int part = 0; part < Parts; ++part) {
    fence_for_issue();
    issue_tile_pv(lst, part);
    wgmma_commit();
    if (Overlap) hand_on();
    wgmma_wait<0>();
    fence_pv();
    if (Parts > 1) fold(part);
  }
  if (signals) bar_arrive(&bars->v_empty[lst]);
  if (Parts == 1) fold(0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// A consumer warp's two rows (row0 and row0 + 8, each written when its flag
// is set), divided by their denominators.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], const float (&l)[2],
                                           float* __restrict__ row0, bool live0, bool live1) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 0 ? live0 : live1) {
      float* orow = row0 + 8 * h * D + 2 * tq;
      const float inv = 1.f / l[h];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    }
  }
}

// A warpgroup's 64 rows of a (rows, D) f32 matrix, multiplied by ``scale``,
// split and written as its hi and lo images (rows >= n_rows as zero; row r
// read from src + r * D), then made visible to wgmma and to the warpgroup.
template <int D>
__device__ __forceinline__ void stage_q(unsigned char* img_hi, unsigned char* img_lo,
                                        const float* __restrict__ src, int n_rows, float scale,
                                        int wg) {
  constexpr int kPer = 2 * (D / 8) * 64 / 128;  // D / 8 chunks a thread, all read first
  const int wt = threadIdx.x & 127;
  float4 x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int r;
    const int c = kimg_chunk(wt + 128 * j, 64, r);
    x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows) x[j] = __ldg(reinterpret_cast<const float4*>(src + r * D + c));
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = wt + 128 * j;
    uint4 hi, lo;
    split4(make_float4(x[j].x * scale, x[j].y * scale, x[j].z * scale, x[j].w * scale), hi,
           lo);
    *reinterpret_cast<uint4*>(img_hi + 16 * i) = hi;
    *reinterpret_cast<uint4*>(img_lo + 16 * i) = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// ------------------------------------------------------------------ K4
// The bias_w table's row stride in the narrow mode: kw or kw + 8 floats,
// whichever is 8 mod 16 (a quad's 8-byte reads of 8 rows in distinct banks).
__host__ __device__ constexpr int narrow_ld(int kw) { return kw % 16 == 0 ? kw + 8 : kw; }
// And in the straddling mode: the least stride >= kw that is 3 mod 16
// floats. A quad's four keys of a read step lie within 8 columns, the 8
// rows of a warp's read step 3 banks apart mod 16, so its 32 reads meet at
// most two to a bank at every kw < 64 (at the stride kw, up to four).
__host__ __device__ constexpr int straddle_ld(int kw) { return kw + (19 - kw % 16) % 16; }

// K4 at head dim D (80: SAM ViT-H; 64: SAM ViT-L and ViT-B; 96). Shared
// memory of a block (from a 1024-byte boundary): each consumer's Q hi and lo
// images, the K stages, the V stages, the bias_w table, the barriers. At D
// 80 one K and one V stage fit beside the table; at D 64 (an image 16 KB)
// two K stages and one V stage do; at D 96 (24 KB) one of each fits beside
// the table only at 64 floats a row (kBwSwizzled: 8-column group j of row r
// stored at group j ^ (r % 8), so a quad's 8-byte reads of 8 rows fall in
// distinct banks).
template <int D>
struct K4Cfg {
  static_assert(D % 16 == 0 && D >= 32 && D <= 128, "K4's head dims");
  static constexpr bool kSmall = D < 64;   // 32 and 48
  static constexpr bool kLarge = D > 96;   // 112 and 128
  static constexpr int kBN = k4_tile(D);  // keys of a tile
  static constexpr int kKStages = D == 64 ? kKStages64 : kSmall ? kKStages32 : ::kKStages;
  static constexpr int kVStages = D == 64 ? kVStages64 : kSmall ? kVStages32 : ::kVStages;
  // (at 112 and 128 always: the output's 56 or 64 registers have no room
  // for a tile's whole P V, and m64n128k8 no instance here)
  static constexpr bool kFold = D == 96 ? kFold96 : kLarge || ::kFold;
  static constexpr int kFoldParts = D == 96 && kFold96 ? kFoldParts96
                                    : D == 112          ? kFoldParts112
                                    : D == 128          ? kFoldParts128
                                                        : 1;
  static constexpr bool kBiasAfter = (D == 96 && kBiasAfter96) || (kLarge && kBiasAfter128);
  static constexpr bool kOverlapped = kOverlap && kFoldParts == 1 && !kBiasAfter;
  static constexpr bool kBwSwizzled = D == 96 || D == 128;
  static constexpr int kBwLdWide = kBwSwizzled ? kGridW : kBwLd;  // the wide mode's row stride
  // the table's room: the widest of the modes' strides (the straddling
  // mode's passes the swizzled 64 at D 96 and 128)
  static constexpr int kBwRoom = std::max(kBwLdWide, straddle_ld(kGridW - 1));
  static constexpr int kQImg = img_bytes<D>(64);   // a consumer's 64 rows of Q
  static constexpr int kImg = img_bytes<D>(kBN);   // a tile's K (or V^T) image
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + 2 * kConsumers * kQImg;
  static constexpr int kVOff = kKOff + 2 * kKStages * kImg;
  static constexpr int kBwOff = kVOff + 2 * kVStages * kImg;
  static constexpr int kBarOff = kBwOff + kBM * kBwRoom * 4;
  static constexpr int kSmemBytes = kBarOff + (int)sizeof(Barriers) + 1024;
  static_assert(kSmemBytes <= 232448, "K4's shared memory");
  // the streamed mode: a bias_w slot (128 rows x kBN floats) a K stage in
  // the table's room, grown where two K stages need more (D 32, 48, 64)
  static constexpr int kSlotFloats = kBM * kBN;
  static constexpr int kStreamBarOff =
      kBwOff + std::max(kBM * kBwRoom, kKStages * kSlotFloats) * 4;
  static constexpr int kStreamSmemBytes = kStreamBarOff + (int)sizeof(Barriers) + 1024;
  static_assert(kStreamSmemBytes <= 232448, "K4's shared memory, the streamed mode");
  static_assert(kKStages <= 2 && kVStages <= 2, "the barriers' stages");
  static_assert(narrow_ld(kGridW - 8) <= kBwRoom, "the narrow mode's table");
  static_assert(kGridW % kBN == 0 && kBN % 32 == 0, "a wide grid row is whole tiles");
  static_assert(kImg % 256 == 0 && kQImg % 256 == 0, "images on the swizzle's period");
};
constexpr int kImg64 = img_bytes(kBN);  // a 64-row image at head dim 80, 20 KB

// Each kBN-key tile of a head as four images (K hi, K lo, V^T hi, V^T lo):
// tile t of head bh at scratch + (bh * n_tiles + t) * 4 * K4Cfg<D>::kImg.
// One block a tile. kRagged (the narrow mode): keys >= S of the last tile as
// zero. K's and V's tiles are read at once where both fit the 48 KB of static
// shared memory (D <= 80, and 112 and 128 at 32 keys); at D 96 V's is read
// into K's once K's images are written.
template <int D, bool kRagged>
__global__ void __launch_bounds__(kSplitThreads) split_kv_relpos_kernel(
    const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ scratch,
    int S) {
  constexpr int kImg = K4Cfg<D>::kImg;
  constexpr int kBN = K4Cfg<D>::kBN;
  constexpr bool kBoth = 2 * kBN * (D + 1) * 4 <= 48 * 1024;
  __shared__ float tk[kBN][D + 1], tv_own[kBoth ? kBN : 1][D + 1];
  float(*tv)[D + 1] = kBoth ? tv_own : tk;
  const int t = blockIdx.x, bh = blockIdx.y, n_tiles = gridDim.x;
  const long long in = ((long long)bh * S + (long long)t * kBN) * D;
  for (int i = threadIdx.x; i < kBN * D; i += kSplitThreads) {
    const int r = i / D, c = i - r * D;
    const bool live = !kRagged || t * kBN + r < S;
    tk[r][c] = live ? k[in + i] : 0.f;
    if (kBoth) tv[r][c] = live ? v[in + i] : 0.f;
  }
  __syncthreads();
  unsigned char* img =
      reinterpret_cast<unsigned char*>(scratch + ((long long)bh * n_tiles + t) * 4 * (kImg / 4));
  for (int i = threadIdx.x; i < 2 * (D / 8) * kBN; i += kSplitThreads) {
    int r;
    const int c = kimg_chunk(i, kBN, r);
    uint4 hi, lo;
    split4(make_float4(tk[r][c], tk[r][c + 1], tk[r][c + 2], tk[r][c + 3]), hi, lo);
    *reinterpret_cast<uint4*>(img + 16 * i) = hi;
    *reinterpret_cast<uint4*>(img + kImg + 16 * i) = lo;
  }
  if (!kBoth) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBN * D; i += kSplitThreads) {
      const int r = i / D, c = i - r * D;
      tv[r][c] = !kRagged || t * kBN + r < S ? v[in + i] : 0.f;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * D * (kBN / 8); i += kSplitThreads) {
    int d;
    const int key = vimg_chunk<D>(i, d);
    uint4 hi, lo;
    split4(make_float4(tv[key][d], tv[key + 2][d], tv[key + 4][d], tv[key + 6][d]), hi, lo);
    *reinterpret_cast<uint4*>(img + 2 * kImg + 16 * i) = hi;
    *reinterpret_cast<uint4*>(img + 3 * kImg + 16 * i) = lo;
  }
}

// kMode: kWideMode, kw = 64 and kh = S / 64 tiles of one grid row each;
// kNarrowMode, a grid of kw < 64 columns, kw a multiple of 8; kStraddleMode,
// any other kw < 64 (its n8 groups of keys straddle grid rows);
// kStreamMode, kw > 64 (a tile's bias_w columns one run of 64 from (64 t) %
// kw, wrapping at most once; the tile in at most two grid rows).
template <int D, int kMode>
__global__ void __launch_bounds__(kThreads, 1) flash_relpos_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ scratch,
    const float* __restrict__ bias_h, const float* __restrict__ bias_w, float* __restrict__ o,
    int S, int kh, int kw, float scale) {
  using C = K4Cfg<D>;
  constexpr int kBN = C::kBN;
  constexpr bool kNarrow = kMode != kWideMode;  // kBN-key tiles across grid rows
  constexpr bool kStraddle = kMode == kStraddleMode;
  constexpr bool kStream = kMode == kStreamMode;
  // the straddling and streamed modes add the whole bias once the products are in
  constexpr bool kBiasAfter = C::kBiasAfter || kStraddle || kStream;
  constexpr bool kOverlapped = C::kOverlapped && !kBiasAfter;
  constexpr int kImg = C::kImg;
  extern __shared__ __align__(1024) unsigned char rt_smem_raw[];
  unsigned char* smem = rt_smem_raw + ((1024 - (smem_u32(rt_smem_raw) & 1023)) & 1023);
  float* sBw = reinterpret_cast<float*>(smem + C::kBwOff);
  Barriers* bars = reinterpret_cast<Barriers*>(smem + (kStream ? C::kStreamBarOff : C::kBarOff));
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int cols = kNarrow ? kw : kGridW;                  // bias_w's columns
  const int ld = kStraddle ? straddle_ld(kw) : kNarrow ? narrow_ld(kw) : C::kBwLdWide;
  // the wide mode's table at D 96 and 128: 8-column group j of row r at j ^ (r % 8)
  constexpr bool kSwizzled = !kNarrow && C::kBwSwizzled;
  const int n_tiles = kNarrow ? (S + kBN - 1) / kBN : kh * (kGridW / kBN);

  // the block's rows of bias_w (zero past S); an odd or unaligned width's
  // rows float by float; none in the streamed mode
  const float* bwg = bias_w + (long long)bh * S * cols;
  if (kStraddle) {
    for (int i = threadIdx.x; i < kBM * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      sBw[r * ld + c] = q0 + r < S ? __ldg(bwg + (long long)(q0 + r) * cols + c) : 0.f;
    }
  }
  for (int i = threadIdx.x; i < (kStraddle || kStream ? 0 : kBM * cols / 4); i += kThreads) {
    const int r = i / (cols / 4), c = 4 * (i % (cols / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S)
      x = __ldg(reinterpret_cast<const float4*>(bwg + (long long)(q0 + r) * cols + c));
    const int at = kSwizzled ? r * ld + ((((c >> 3) ^ r) & 7) << 3) + (c & 7) : r * ld + c;
    *reinterpret_cast<float4*>(sBw + at) = x;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      // the streamed mode's K stage is full once its slot's copies are in too
      bar_init(&bars->k_full[st], 1 + (kStream && kBwStreamed ? kFillThreads : 0));
      bar_init(&bars->v_full[st], 1);
      bar_init(&bars->k_empty[st], kConsumerWarps);
      bar_init(&bars->v_empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const long long tile_bytes = 4LL * kImg;
  const int lane = threadIdx.x & 31;
  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x == 128 * kConsumers) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(scratch) + (long long)bh * n_tiles * tile_bytes;
      for (int t = 0; t < n_tiles; ++t) {
        const int kst = t % C::kKStages, kparity = ((t / C::kKStages) & 1) ^ 1;
        const int vst = t % C::kVStages, vparity = ((t / C::kVStages) & 1) ^ 1;
        bar_wait_or_trap(&bars->k_empty[kst], kparity);
        bar_expect_tx(&bars->k_full[kst], 2 * kImg);
        bulk_load(smem + C::kKOff + kst * 2 * kImg, src + t * tile_bytes, 2 * kImg,
                  &bars->k_full[kst]);
        bar_wait_or_trap(&bars->v_empty[vst], vparity);
        bar_expect_tx(&bars->v_full[vst], 2 * kImg);
        bulk_load(smem + C::kVOff + vst * 2 * kImg, src + t * tile_bytes + 2 * kImg, 2 * kImg,
                  &bars->v_full[vst]);
      }
    } else if (kStream && kBwStreamed && threadIdx.x >= 128 * kConsumers + 32) {
      // the streamed mode's slot of tile t's K stage: row r's run of kBN
      // bias_w columns from (kBN t) % kw (wrapping at most once, kw > 64),
      // column c at r * kBN + ((c / 8) ^ (r % (kBN / 8))) * 8 + c % 8, zero
      // past S; warp w of the three copies rows w, w + 3, ..., a row's 32
      // columns a copy step, and each thread's arrival on the K stage's full
      // barrier comes when its copies are in
      static_assert(kBN == 32 || kBN == 64, "one or two copy steps a row");
      constexpr int kGroups = kBN / 8;
      const int fw = (threadIdx.x - 128 * kConsumers) / 32 - 1;
      const float* bw_block = bias_w + ((long long)bh * S + q0) * kw;
      for (int t = 0; t < n_tiles; ++t) {
        const int kst = t % C::kKStages, kparity = ((t / C::kKStages) & 1) ^ 1;
        bar_wait_or_trap(&bars->k_empty[kst], kparity);
        int x0 = t * kBN % kw + lane, x1 = x0 + 32;
        x0 = x0 >= kw ? x0 - kw : x0;
        x1 = x1 >= kw ? x1 - kw : x1;
        float* slot = sBw + kst * C::kSlotFloats + (lane & 7);
#pragma unroll 4
        for (int r = fw; r < kBM; r += 3) {
          const bool live = q0 + r < S;
          const float* src = bw_block + (long long)r * kw;
          bff_tc::cp_async4(slot + r * kBN + (((lane >> 3) ^ (r & (kGroups - 1))) << 3),
                            live ? src + x0 : bias_w, live ? 4 : 0);
          if constexpr (kBN == 64)
            bff_tc::cp_async4(slot + r * kBN + ((((lane >> 3) + 4) ^ (r & (kGroups - 1))) << 3),
                              live ? src + x1 : bias_w, live ? 4 : 0);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                         smem_u32(&bars->k_full[kst]))
                     : "memory");
      }
      bff_tc::cp_async_wait<0>();
    }
  } else {
    // ---------------------------------------------------------- consumers
    const int tq = lane & 3;
    const int rb = wg * 64 + ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // and rb + 8
    unsigned char* q_hi = smem + C::kQOff + 2 * wg * C::kQImg;
    unsigned char* q_lo = q_hi + C::kQImg;
    stage_q<D>(q_hi, q_lo, q + ((long long)bh * S + q0 + wg * 64) * D, S - q0 - wg * 64, scale,
               wg);
    if (kPingpong && wg == kConsumers - 1) turn_arrive(1 + (wg + 1) % kConsumers);

    const float* bw_row[2] = {sBw + rb * ld + 2 * tq, sBw + (rb + 8) * ld + 2 * tq};
    const int bw_sw = kSwizzled ? lane / 4 : 0;  // (rb + 8 h) % 8: the rows' swizzle
    const float* bh_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bh_row[h] = q0 + rb + 8 * h < S ? bias_h + ((long long)bh * S + q0 + rb + 8 * h) * kh
                                      : nullptr;
    // tile t: the accumulators start at bias_w (the same for every tile of
    // a grid row; at 32-key tiles, D 112 and 128, the row's half t % 2), the
    // rows shift by bias_h[q, t / (64 / kBN)] in log2 units
    auto init_wide = [&](int t, float (&s)[kBN / 2], float (&sh)[2][1]) {
      constexpr int kPerRow = kGridW / kBN;  // tiles a grid row
      const int g0 = (t % kPerRow) * (kBN / 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sh[h][0] = bh_row[h] != nullptr ? __ldg(bh_row[h] + t / kPerRow) * kL2e : 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(bw_row[h] + 8 * ((g0 + j) ^ bw_sw));
          s[4 * j + 2 * h] = w.x;
          s[4 * j + 2 * h + 1] = w.y;
        }
      }
    };
    // the narrow mode's tile t: the accumulators start at bias_w[q, kx]
    // (keys >= S at -inf), and each n8 group's keys shift by bias_h[q, ky]
    // in log2 units. n8 group j holds keys 64 t + 8 j .. + 7, one grid row
    // (kw % 8 == 0): (ky, kx) of the group's first key, advanced by 8 keys
    // a group and set once a tile
    auto init_narrow = [&](int t, float (&s)[kBN / 2], float (&sh)[2][kBN / 8]) {
      int ky = t * kBN / kw, kx = t * kBN - ky * kw;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const bool in = t * kBN + 8 * j < S;  // S is a multiple of 8: the whole group
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sh[h][j] = in && bh_row[h] != nullptr ? __ldg(bh_row[h] + ky) * kL2e : 0.f;
          const float2 w = *reinterpret_cast<const float2*>(bw_row[h] + kx);
          s[4 * j + 2 * h] = in ? w.x : bff_tc::masked_score();
          s[4 * j + 2 * h + 1] = in ? w.y : bff_tc::masked_score();
        }
        kx += 8;
        if (kx >= kw) {
          kx -= kw;
          ++ky;
        }
      }
    };
    // the straddling mode's tile t: each score's initial value is its whole
    // bias, bias_h[q, ky] + bias_w[q, kx] with (ky, kx) = (key / kw, key %
    // kw) of its own key (keys >= S at -inf), added once the products are in
    // (kBiasAfter; these reads run while the products do); no row shift. The
    // lane's keys are 64 t + 8 j + 2 tq + e: (ky, kx) of its e = 0 key set
    // once a tile by a division and advanced by 8 keys a group, by one wrap
    // where kw >= 8 and a division below; the e = 1 key is the next column
    // or the next row's first. bias_w is read float by float (an odd kw's
    // pairs are not 8-byte aligned), at straddle_ld's stride
    const float* bw_base[2] = {sBw + rb * ld, sBw + (rb + 8) * ld};
    auto init_straddle = [&](int t, float (&s)[kBN / 2], float (&sh)[2][1]) {
      sh[0][0] = sh[1][0] = 0.f;
      int key = t * kBN + 2 * tq;
      int ky = key / kw, kx = key - ky * kw;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool wrap = e == 1 && kx + 1 == kw;
          const int y = ky + wrap, x = e == 0 ? kx : wrap ? 0 : kx + 1;
          const bool in = key + e < S;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float b = in && bh_row[h] != nullptr ? __ldg(bh_row[h] + y) : 0.f;
            const float w = bw_base[h][in ? x : 0];
            s[4 * j + 2 * h + e] = in ? b + w : bff_tc::masked_score();
          }
        }
        key += 8;
        if (kw >= 8) {
          kx += 8;
          if (kx >= kw) {
            kx -= kw;
            ++ky;
          }
        } else {
          ky = key / kw;
          kx = key - ky * kw;
        }
      }
    };
    // the streamed mode's tile t: as the straddling mode's, each score's
    // whole bias added once the products are in, no row shift; the tile's
    // keys lie in grid rows ky and ky + 1 (columns from ``split`` on in the
    // second), so bias_h is two reads a row, and bias_w comes from the slot
    // of the tile's K stage (kBwStreamed: in by the time the stage is full,
    // released with it once the products are in, so no barrier of its own),
    // a quad's 8-byte pairs of 8 rows filling each bank twice; or, without
    // it, each score's from device memory. Straight-line: a branch between
    // the products' issue and their wait would serialize every wgmma (C7520).
    const float* bw_dev[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bw_dev[h] = q0 + rb + 8 * h < S ? bias_w + ((long long)bh * S + q0 + rb + 8 * h) * kw
                                      : nullptr;
    auto init_stream = [&](int t, float (&s)[kBN / 2], float (&sh)[2][1]) {
      sh[0][0] = sh[1][0] = 0.f;
      const int key0 = t * kBN, ky = key0 / kw, kx0 = key0 - ky * kw;
      const int split = kw - kx0;  // the tile's columns from here on lie in grid row ky + 1
      float h0[2], h1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        h0[h] = bh_row[h] != nullptr ? __ldg(bh_row[h] + ky) : 0.f;
        h1[h] = bh_row[h] != nullptr && split < kBN && ky + 1 < kh ? __ldg(bh_row[h] + ky + 1)
                                                                 : 0.f;
      }
      const float* slot = sBw + (t % C::kKStages) * C::kSlotFloats + rb * kBN + 2 * tq;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float w[2];
          if constexpr (kBwStreamed) {
            const float2 p = *reinterpret_cast<const float2*>(
                slot + 8 * h * kBN +
                ((j ^ (kBN == kGridW ? lane / 4 : (lane / 4) & (kBN / 8 - 1))) << 3));
            w[0] = p.x;
            w[1] = p.y;
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + 2 * tq + e;
              const int x = kx0 + c >= kw ? kx0 + c - kw : kx0 + c;
              w[e] = bw_dev[h] != nullptr && key0 + c < S ? __ldg(bw_dev[h] + x) : 0.f;
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * tq + e;
            s[4 * j + 2 * h + e] =
                key0 + c < S ? (c < split ? h0[h] : h1[h]) + w[e] : bff_tc::masked_score();
          }
        }
      }
      // every lane's slot reads before the warp's lane 0 releases the K
      // stage (and so the slot) once the products are in
      if constexpr (kBwStreamed) __syncwarp();
    };
    const Ring ring{bars, smem_u32(smem + C::kKOff), smem_u32(smem + C::kVOff)};
    float acc[D / 2], l[2];
    if constexpr (kStream)
      attend_rows<kBN, C::kKStages, C::kVStages, kOverlapped, D, 1, C::kFold, C::kFoldParts,
                  kBiasAfter, true>(acc, l, smem_u32(q_hi), smem_u32(q_lo), ring, 0, n_tiles,
                                    wg, init_stream);
    else if constexpr (kStraddle)
      attend_rows<kBN, C::kKStages, C::kVStages, kOverlapped, D, 1, C::kFold, C::kFoldParts,
                  kBiasAfter>(acc, l, smem_u32(q_hi), smem_u32(q_lo), ring, 0, n_tiles, wg,
                              init_straddle);
    else if constexpr (kNarrow)
      attend_rows<kBN, C::kKStages, C::kVStages, kOverlapped, D, kBN / 8, C::kFold,
                  C::kFoldParts, kBiasAfter>(acc, l, smem_u32(q_hi), smem_u32(q_lo), ring, 0,
                                             n_tiles, wg, init_narrow);
    else
      attend_rows<kBN, C::kKStages, C::kVStages, kOverlapped, D, 1, C::kFold,
                  C::kFoldParts, kBiasAfter>(acc, l, smem_u32(q_hi), smem_u32(q_lo), ring, 0,
                                             n_tiles, wg, init_wide);
    if (kPingpong && wg == 0) turn_sync(1);  // the last consumer's last turn
    const int row = q0 + rb;
    store_rows<D>(acc, l, o + ((long long)bh * S + row) * D, row < S, row + 8 < S);
  }
}

template <int D, int kMode>
int launch_k4(const void* q, const void* k, const void* v, const void* bias_h,
              const void* bias_w, void* o, void* scratch, int BH, int S, int kh, int kw,
              float scale, cudaStream_t s) {
  constexpr int kSmem = kMode == kStreamMode ? K4Cfg<D>::kStreamSmemBytes : K4Cfg<D>::kSmemBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_relpos_tf32_kernel<D, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int kBN = K4Cfg<D>::kBN;
  const int n_tiles = (S + kBN - 1) / kBN;  // kh (64 / kBN) at kw = 64
  split_kv_relpos_kernel<D, kMode != kWideMode><<<dim3(n_tiles, BH), kSplitThreads, 0, s>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(scratch),
      S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_relpos_tf32_kernel<D, kMode><<<dim3((S + kBM - 1) / kBM, BH), kThreads, kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(scratch),
      static_cast<const float*>(bias_h), static_cast<const float*>(bias_w),
      static_cast<float*>(o), S, kh, kw, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K5
// Shared memory of a K5 block: per consumer its Q hi and lo images and its
// rows of the two factor tables; then the stages (K hi, K lo, V^T hi, V^T
// lo of a 40-key tile each); the barriers.
constexpr int kImg40 = img_bytes(kWBN);            // 12 800 bytes
constexpr int kWTable = 64 * kWin * 4;             // a consumer's rows of one factor table
constexpr int kWConsumerBytes = 2 * kImg64 + 2 * kWTable;  // 48 128
constexpr int kWKOff = kConsumers * kWConsumerBytes;
constexpr int kWVOff = kWKOff + kWStages * 2 * kImg40;
constexpr int kWBarOff = kWVOff + kWStages * 2 * kImg40;
constexpr int kWSmemBytes = kWBarOff + (int)sizeof(Barriers) + 1024;
static_assert(kWSmemBytes <= 232448, "K5's shared memory");
static_assert(kWConsumerBytes % 256 == 0 && kImg40 % 256 == 0,
              "images start on the 32-byte swizzle's 256-byte period");

__global__ void __launch_bounds__(kThreads, 1) window_relpos_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias_h, const float* __restrict__ bias_w, float* __restrict__ o,
    int G, float scale) {
  extern __shared__ __align__(1024) unsigned char wt_smem_raw[];
  unsigned char* smem = wt_smem_raw + ((1024 - (smem_u32(wt_smem_raw) & 1023)) & 1023);
  Barriers* bars = reinterpret_cast<Barriers*>(smem + kWBarOff);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kWStages; ++st) {
      bar_init(&bars->k_full[st], 128);
      bar_init(&bars->v_full[st], 128);
      bar_init(&bars->k_empty[st], kConsumerWarps);
      bar_init(&bars->v_empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int n_items = kWRounds * G;
  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    const int pt = threadIdx.x & 127;
    constexpr int kChunks = 2 * (kD / 8) * kWBN;  // 800 of each image
    constexpr int kPer = (kChunks + 127) / 128;
    // the block's tiles u = 0 .. n_tiles - 1: item blockIdx.x + (u / 5) *
    // gridDim.x, key tile u % 5; tile u + 1 is read from device memory
    // while tile u is split and written
    const int n_tiles = (n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * kWTiles;
    auto load = [&](int u, float4 (&xk)[kPer], float4 (&xv)[kPer]) {
      const int item = blockIdx.x + (u / kWTiles) * gridDim.x;
      const int k0 = (u % kWTiles) * kWBN;
      const long long base = (long long)(item / kWRounds) * kWinS * kD;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = pt + 128 * j;
        xk[j] = xv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < kChunks) {
          int r;
          const int c = kimg_chunk(i, kWBN, r);
          if (k0 + r < kWinS)
            xk[j] = __ldg(reinterpret_cast<const float4*>(k + base + (k0 + r) * kD + c));
          // V^T: each chunk the values of one feature for four keys of a group
          int d;
          const int key = k0 + vimg_chunk<kD>(i, d);
          const float* src = v + base + (long long)key * kD + d;
          if (key < kWinS) xv[j].x = __ldg(src);
          if (key + 2 < kWinS) xv[j].y = __ldg(src + 2 * kD);
          if (key + 4 < kWinS) xv[j].z = __ldg(src + 4 * kD);
          if (key + 6 < kWinS) xv[j].w = __ldg(src + 6 * kD);
        }
      }
    };
    auto store = [&](unsigned char* img, const float4 (&x)[kPer]) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = pt + 128 * j;
        if (i < kChunks) {
          uint4 hi, lo;
          split4(x[j], hi, lo);
          *reinterpret_cast<uint4*>(img + 16 * i) = hi;
          *reinterpret_cast<uint4*>(img + kImg40 + 16 * i) = lo;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    float4 xk[kPer], xv[kPer], nk[kPer], nv[kPer];
    load(0, xk, xv);
    for (int u = 0; u < n_tiles; ++u) {
      const int st = u % kWStages, parity = ((u / kWStages) & 1) ^ 1;
      if (kWPrefetch && u + 1 < n_tiles) load(u + 1, nk, nv);
      bar_wait_or_trap(&bars->k_empty[st], parity);
      store(smem + kWKOff + st * 2 * kImg40, xk);
      bar_arrive(&bars->k_full[st]);
      bar_wait_or_trap(&bars->v_empty[st], parity);
      store(smem + kWVOff + st * 2 * kImg40, xv);
      bar_arrive(&bars->v_full[st]);
      if (!kWPrefetch) {
        if (u + 1 < n_tiles) load(u + 1, xk, xv);
        continue;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        xk[j] = nk[j];
        xv[j] = nv[j];
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    const int lane = threadIdx.x & 31, tq = lane & 3;
    const int wrow = ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // the lane's row of 64, and + 8
    unsigned char* mine = smem + wg * kWConsumerBytes;
    unsigned char* q_hi = mine;
    unsigned char* q_lo = mine + kImg64;
    float* tab_h = reinterpret_cast<float*>(mine + 2 * kImg64);
    float* tab_w = tab_h + 64 * kWin;
    const Ring ring{bars, smem_u32(smem + kWKOff), smem_u32(smem + kWVOff)};
    if (kPingpong && wg == kConsumers - 1) turn_arrive(1 + (wg + 1) % kConsumers);
    int u = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, u += kWTiles) {
      const int g = item / kWRounds;
      const int r0 = (item % kWRounds) * kBM + wg * 64;  // the warpgroup's first row of the window
      const long long base = (long long)g * kWinS * kD;
      // every warp of the warpgroup is past the last item's reads
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
      // the rows' factors (zero past 196), then Q (which syncs the warpgroup)
      const long long fbase = ((long long)g * kWinS + r0) * kWin;
      constexpr int kTabPer = 64 * kWin / 128;  // 7 values of each table a thread
      float fh[kTabPer], fw[kTabPer];
#pragma unroll
      for (int j = 0; j < kTabPer; ++j) {
        const int i = (threadIdx.x & 127) + 128 * j;
        const bool live = r0 + i / kWin < kWinS;
        fh[j] = live ? __ldg(bias_h + fbase + i) : 0.f;
        fw[j] = live ? __ldg(bias_w + fbase + i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTabPer; ++j) {
        tab_h[(threadIdx.x & 127) + 128 * j] = fh[j];
        tab_w[(threadIdx.x & 127) + 128 * j] = fw[j];
      }
      stage_q<kD>(q_hi, q_lo, q + base + (long long)r0 * kD, kWinS - r0, scale, wg);
      const float* th[2] = {tab_h + wrow * kWin, tab_h + (wrow + 8) * kWin};
      const float* tw[2] = {tab_w + wrow * kWin, tab_w + (wrow + 8) * kWin};
      // tile t: each score starts at its bias; keys >= 196 at -inf
      auto init = [&](int t, float (&s)[kWBN / 2], float (&sh)[2][1]) {
        sh[0][0] = sh[1][0] = 0.f;
#pragma unroll
        for (int j = 0; j < kWBN / 8; ++j) {
          const int c = t * kWBN + 8 * j + 2 * tq;  // the lane's key pair c, c + 1: one grid row
          const int ky = c / kWin, kx = c - ky * kWin;
          const bool in = c < kWinS;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float b = th[h][in ? ky : 0];
            const float2 w = *reinterpret_cast<const float2*>(tw[h] + (in ? kx : 0));
            s[4 * j + 2 * h] = in ? b + w.x : bff_tc::masked_score();
            s[4 * j + 2 * h + 1] = in ? b + w.y : bff_tc::masked_score();
          }
        }
      };
      float acc[40], l[2];
      attend_rows<kWBN, kWStages, kWStages, kWOverlap, kD, 1, kFold, 1, false>(
          acc, l, smem_u32(q_hi), smem_u32(q_lo), ring, u, kWTiles, wg, init);
      const int row = r0 + wrow;
      store_rows<kD>(acc, l, o + base + (long long)row * kD, row < kWinS, row + 8 < kWinS);
    }
    if (kPingpong && wg == 0) turn_sync(1);  // the last consumer's last turn
  }
}

// K4's head dims: the K4Cfg instances, the multiples of 16 from kMinK4D to kMaxK4D
bool k4_dim(int D) { return D % 16 == 0 && D >= kMinK4D && D <= kMaxK4D; }

bool aligned(const void* q, const void* k, const void* v, const void* o, const void* bh,
             const void* bw) {
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(bh) &&
         aligned16(bw);
}

}  // namespace

// The routing predicate (kernels/flash_attention.py relpos_tf32_route
// mirrors it): 1 when bff_flash_attention_relpos (kind 0, K4; rows x cols =
// kh x kw) or bff_window_attention_relpos (kind 1, K5; wh x ww) takes the
// 3xTF32 kernel for the call: K4 at head dims 32 to 128 in steps of 16 on
// grids of any height from kMinGridH with kw = 64, kw a multiple of 8 in [kMinGridW, 64)
// (the narrow mode) or any other kw in [kMinStraddleW, 64) (the
// straddling mode), K5 at 80. (bff_window_attention_relpos also asks with
// kind 0 for its windows past 256 tokens, G windows as BH.) Grids wider
// than 64 are bff_relpos_tf32_streamed_takes's.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int bff_relpos_tf32_takes(int kind, int dtype, int D, int S, int rows, int cols,
                                     float scale, const void* q, const void* k, const void* v,
                                     const void* o, const void* bias_h, const void* bias_w) {
  const bool width =
      cols == kGridW ||
      (cols < kGridW && (cols % 8 == 0 ? cols >= kMinGridW : cols >= kMinStraddleW));
  const bool shape = kind == 0   ? width && rows >= kMinGridH && (long long)rows * cols == S &&
                                     k4_dim(D)
                     : kind == 1 ? rows == kWin && cols == kWin && S == kWinS && D == kD
                                 : false;
  return shape && dtype == 0 && scale > 0.f && scale <= FLT_MAX &&
         aligned(q, k, v, o, bias_h, bias_w);
}

// The streamed mode's predicate (kernels/flash_attention.py
// relpos_tf32_streamed_route mirrors it): 1 when K4's kernels (kind 0, a
// rows x cols = kh x kw grid; bff_window_attention_relpos asks so for its
// windows past 256 tokens) take the 3xTF32 kernel in the streamed mode: f32
// at head dims 32 to 128 in steps of 16, any kh >= 1 and kw past 64, a positive finite
// scale and every pointer on 16 bytes. The entry is bff_flash_relpos_tf32.
extern "C" int bff_relpos_tf32_streamed_takes(int kind, int dtype, int D, int S, int rows,
                                              int cols, float scale, const void* q,
                                              const void* k, const void* v, const void* o,
                                              const void* bias_h, const void* bias_w) {
  const bool shape =
      kind == 0 && rows >= 1 && cols > kGridW && (long long)rows * cols == S && k4_dim(D);
  return shape && dtype == 0 && scale > 0.f && scale <= FLT_MAX &&
         aligned(q, k, v, o, bias_h, bias_w);
}

// The scratch a K4 call at head dim D needs (every mode), in floats: each
// tile's K hi, K lo, V^T hi and V^T lo images, 4 BH Sp D with Sp = S rounded
// up to the tile's keys (64; 32 at D 112 and 128; S itself at kw = 64).
extern "C" long long bff_relpos_tf32_scratch_floats(int BH, int S, int D) {
  const int bn = k4_tile(D);
  return 4LL * BH * ((S + bn - 1) / bn * bn) * D;
}

// K4, every mode. q, k, v, o: contiguous (BH, S, D) f32 with S = kh * kw
// and D 32, 48, 64, 80, 96, 112 or 128; bias_h (BH, S, kh), bias_w (BH, S, kw) f32; scratch:
// 16-byte aligned, at least bff_relpos_tf32_scratch_floats floats, on the
// same stream. Returns cudaGetLastError() after the launches, -1 for
// arguments outside both predicates or no scratch.
extern "C" int bff_flash_relpos_tf32(const void* q, const void* k, const void* v,
                                     const void* bias_h, const void* bias_w, void* o,
                                     void* scratch, int BH, int S, int D, int kh, int kw,
                                     float scale, void* stream) {
  if (BH < 1 || scratch == nullptr || !aligned16(scratch) ||
      !(bff_relpos_tf32_takes(0, 0, D, S, kh, kw, scale, q, k, v, o, bias_h, bias_w) ||
        bff_relpos_tf32_streamed_takes(0, 0, D, S, kh, kw, scale, q, k, v, o, bias_h, bias_w)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFF_K4(DIM, MODE) \
  launch_k4<DIM, MODE>(q, k, v, bias_h, bias_w, o, scratch, BH, S, kh, kw, scale, s)
#define BFF_K4_DIMS(MODE)                                                                \
  (D == 32    ? BFF_K4(32, MODE)                                                         \
   : D == 48  ? BFF_K4(48, MODE)                                                         \
   : D == 64  ? BFF_K4(64, MODE)                                                         \
   : D == 96  ? BFF_K4(96, MODE)                                                         \
   : D == 112 ? BFF_K4(112, MODE)                                                        \
   : D == 128 ? BFF_K4(128, MODE)                                                        \
              : BFF_K4(kD, MODE))
  if (kw > kGridW) return BFF_K4_DIMS(kStreamMode);
  if (kw == kGridW) return BFF_K4_DIMS(kWideMode);
  if (kw % 8 == 0) return BFF_K4_DIMS(kNarrowMode);
  return BFF_K4_DIMS(kStraddleMode);
#undef BFF_K4_DIMS
#undef BFF_K4
}

// K5. q, k, v, o: contiguous (G, 196, 80) f32; bias_h, bias_w (G, 196, 14)
// f32. Return codes as bff_flash_relpos_tf32's.
extern "C" int bff_window_relpos_tf32(const void* q, const void* k, const void* v,
                                      const void* bias_h, const void* bias_w, void* o, int G,
                                      float scale, void* stream) {
  if (G < 1 ||
      !bff_relpos_tf32_takes(1, 0, kD, kWinS, kWin, kWin, scale, q, k, v, o, bias_h, bias_w))
    return -1;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_relpos_tf32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmemBytes);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const int grid = std::min(kWRounds * G, sms);
  window_relpos_tf32_kernel<<<grid, kThreads, kWSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias_h), static_cast<const float*>(bias_w),
      static_cast<float*>(o), G, scale);
  return (int)cudaGetLastError();
}
