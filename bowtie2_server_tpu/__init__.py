"""bowtie2_server_tpu — a batched, accelerator-resident short-read aligner
with Bowtie 2's capabilities.

A from-scratch reimplementation of the capabilities of sfiligoi/bowtie2-server
(Bowtie 2 + client/server mode) whose search runs as batched device programs:

- The two regular compute cores run on the device as JAX/XLA programs:
  (1) batched FM-index ops (LF-mapping = gathers + in-block counts over a
      checkpointed occ table), replacing the scalar prefetch-tuned loops of
      the reference (ref: bt2_idx.h:1758 countBt2Side, aligner_seed.cpp:854);
  (2) batched banded affine-gap Smith-Waterman (an XLA scan), replacing the
      SSE striped kernels (ref: aligner_swsse_{ee,loc}_{u8,i16}.cpp).
- SA resolution is a single device gather over a full suffix array kept in
  HBM, replacing the sampled-SA group-walk (ref: group_walk.h) — HBM capacity
  traded for eliminating a latency-bound LF pointer chase.
- The host runtime (FASTQ/SAM, reporting policy, BT2SRV wire protocol
  server/client) mirrors the reference's host-side behavior.

Package layout:
  index/    FM-index build + load (+ .bt2 interop)        (ref: bt2_idx.*, bt2_io.cpp, bt2_build.cpp)
  ops/      device kernels: FM search, Smith-Waterman     (ref: aligner_seed.cpp, aligner_swsse_*.cpp)
  align/    the staged alignment pipeline + policy        (ref: bt2_search.cpp, aligner_sw_driver.cpp)
  io/       FASTQ/tab6 input, SAM output                  (ref: pat.*, sam.*)
  server/   BT2SRV HTTP/1.1 protocol server + client      (ref: pat.cpp:1823-2789)
  parallel/ device mesh / sharding helpers                (ref: §2.3 thread-level DP → chip-level DP)
  utils/    scoring, simple-func, small helpers           (ref: scoring.*, simple_func.*)
"""

__version__ = "0.1.0"
