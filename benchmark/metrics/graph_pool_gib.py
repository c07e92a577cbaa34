"""graph_pool_gib (GiB): the bytes the caching allocator holds in the
captured graphs' private pool after set-up (driver/compiled.py:
graph_pool), part of peak_mem_gib."""


def read(ctx):
    return ctx.pool_bytes / 2.0 ** 30 if ctx.pool_bytes else None
