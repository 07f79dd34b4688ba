"""P2 and P3: the K/V column-write variants of ``scripts/probe_cache_write2.py``
and ``probe_cache_write3.py`` on the card, beside the port's own per-step
append (K2, ``kv_cache_append``) on its (S, D) cache.

    python -m chatterbox_tpu_torch.probes.cache_write [--device cpu]

Each variant writes one column (L, 2, B, H, D) at slot ``POS`` of an
(L, 2, B, H, D, S) bf16 cache (the TPU layout), in place; it must equal the
plain slice assignment bit for bit, and is timed as a chain of 30 writes in
a CUDA graph, as the scripts time it, and once with the L2 flushed first.
The variants differ in the work of one Pallas grid cell; on the card they
all launch one column-write kernel, so each moves the column read and
written once and dirties one 32-byte sector per value. K2 writes the same
column into an (L, 2, B, H, S, D) cache, the layout the port chose
(ROADMAP C3).
"""

import torch

from ..ops.flash_decode import device_position, kv_cache_append, kv_cache_append_plain
from ..ops.probes import cache_block_rmw, cache_column_write, cache_column_write_plain
from . import cold_ms, device_name, graph_ms, main

L, B, H, D, S, POS = 30, 16, 16, 64, 384, 200  # the scripts' shapes and slot
CHAIN = 30
# (script, variant): the arguments of the wrapper, as the Pallas variant takes them
VARIANTS = {
    ("P2", "rmw b_blk=8 kvsep"): dict(kind="rmw", b_blk=8, s_blk=128, fold_kv=False),
    ("P2", "rmw b_blk=8 kvfold"): dict(kind="rmw", b_blk=8, s_blk=128, fold_kv=True),
    ("P2", "rmw b_blk=16 kvfold"): dict(kind="rmw", b_blk=16, s_blk=128, fold_kv=True),
    ("P2", "col b_blk=16"): dict(kind="col", b_blk=16),
    ("P2", "col b_blk=4"): dict(kind="col", b_blk=4),
    ("P3", "col b_blk=16"): dict(kind="col", b_blk=16),
    ("P3", "col b_blk=4"): dict(kind="col", b_blk=4),
    ("P3", "rmw b_blk=8 s_blk=64"): dict(kind="rmw", b_blk=8, s_blk=64, fold_kv=False),
}


def write(cache, new, pos, variant):
    """The variant's kernel (its plain version on the CPU); in place."""
    if variant["kind"] == "col":
        return cache_column_write(cache, new, pos, variant["b_blk"])
    return cache_block_rmw(cache, new, pos, variant["b_blk"], variant["s_blk"],
                           variant["fold_kv"])


def moved_bytes(shape):
    """Bytes every variant moves: the bf16 column read and written once."""
    return 2 * 2 * sectors_written(shape)


def sectors_written(shape):
    """32-byte sectors the column's stores dirty: one a value, since each
    value lies S * 2 bytes from the next (at least a sector for S >= 16)."""
    return shape[0] * 2 * shape[2] * shape[3] * shape[4]


def make_inputs(device, l=L, b=B, h=H, d=D, s=S, seed=0):
    """A random bf16 cache (l, 2, b, h, d, s) and column (l, 2, b, h, d, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    cache = torch.randn((l, 2, b, h, d, s), generator=g, device=device).to(torch.bfloat16)
    new = torch.randn((l, 2, b, h, d, 1), generator=g, device=device).to(torch.bfloat16)
    return cache, new


def _launches():
    return cache_column_write.launches + cache_block_rmw.launches


def run(device, l=L, b=B, h=H, d=D, s=S, pos=POS):
    """Every variant, then K2: checked bit for bit against the plain slice
    assignment (raises otherwise), then timed per write over a chain of 30
    and once cold (CUDA only). Returns the results, with each variant's
    kernel launches."""
    cache, new = make_inputs(device, l, b, h, d, s)
    want = cache_column_write_plain(cache.clone(), new, pos)
    out = {"probe": "P2/P3 cache column writes", "device": device_name(device),
           "shape": [l, 2, b, h, d, s], "pos": pos, "variants": {}}
    for (script, name), variant in VARIANTS.items():
        before = _launches()
        if not torch.equal(write(cache.clone(), new, pos, variant), want):
            raise AssertionError(f"{script} {name}: the write differs from the slice assignment")
        r = {"exact": True, "moved_bytes": moved_bytes(cache.shape),
             "sectors_written": sectors_written(cache.shape)}
        if device.type == "cuda":
            r["ms"] = graph_ms(lambda v=variant: write(cache, new, pos, v), CHAIN)
            cold, least, most = cold_ms(lambda v=variant: write(cache, new, pos, v))
            r.update(cold_ms=cold, cold_spread_ms=[least, most])
        r["launches"] = _launches() - before
        out["variants"][f"{script} {name}"] = r
    # K2 on the port's (S, D) layout, same column
    sd = cache.transpose(-1, -2).contiguous()
    new_sd = new[..., 0].contiguous()
    pos_dev = device_position(pos, sd.device)  # K2 reads its slot on the device
    before = kv_cache_append.launches
    if not torch.equal(kv_cache_append(sd.clone(), new_sd, pos_dev),
                       kv_cache_append_plain(sd.clone(), new_sd, pos)):
        raise AssertionError("K2: the append differs from the slice assignment")
    r = {"exact": True, "moved_bytes": 2 * new_sd.numel() * 2}
    if device.type == "cuda":
        r["ms"] = graph_ms(lambda: kv_cache_append(sd, new_sd, pos_dev), CHAIN)
    r["launches"] = kv_cache_append.launches - before
    out["variants"]["K2 kv_cache_append (S, D)"] = r
    return out


if __name__ == "__main__":
    main(run, __doc__.splitlines()[0])
