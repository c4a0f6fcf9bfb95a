"""Multi-device layer: one process per rank over ``torch.distributed``.

Counterpart of ``krylov_crn_tpu/parallel``. Rows of A (d-space path) or
row bands of K (Gram path) are split over the ranks of a ``Mesh``; the
dense iterate and every solver vector of the Gram path are replicated.
A band cuts the bytes a rank reads per K-matvec, not what K's build
needs: ``build_gram(mesh=)`` builds the whole K on every rank and keeps
its band, so K must still fit one card.

* ``mesh``      — the ``Mesh`` value and the counted collectives;
* ``launch``    — ``run_ranks``: start N ranks of one function and join them;
* ``sharded``   — ``ShardedDual``: the row-partitioned A and its products;
* ``multihost`` — per-rank LIBSVM byte-range loading.
"""
