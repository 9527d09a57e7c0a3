"""The map phase (counterpart of ``tmr_tpu/parallel``'s ``mapreduce``, ``journal``,
``leases`` and ``elastic``): the streaming feature extractor over tar shards, its
retrying executor, its crash-resume journal, and the elastic map phase (a coordinator
that leases shards to workers under epoch fences, ``parallel/leases.py`` and
``parallel/elastic.py``). The mesh, sharding, ring and pipeline modules are not ported
yet (ROADMAP A7)."""
