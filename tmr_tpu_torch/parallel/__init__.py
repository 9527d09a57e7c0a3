"""The map phase (counterpart of ``tmr_tpu/parallel``'s ``mapreduce`` and ``journal``):
the streaming feature extractor over tar shards, its retrying executor and its
crash-resume journal. The mesh, sharding, ring, pipeline, lease and elastic modules are
not ported yet (ROADMAP A5, A7)."""
