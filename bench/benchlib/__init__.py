"""The benchmark's own code: what a cell is made of (``spec``), its traffic
(``traffic``), its inputs (``inputs``), the served window (``serve``), the
device trace (``profile``), the frozen work counts (``workcount``), the
arithmetic of its metrics (``latency``, ``result``) and the comparison that
decides ``correct`` (``check``).

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; the program under test, ``repro_torch``, is imported only by
``serve`` and ``check``, and ``bench/reference`` imports none of it.
"""
