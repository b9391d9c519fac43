"""Native plan-ops (packed radix sort + fused unique) vs numpy reference."""

import numpy as np

from dot_tpu import native


def test_sort_unique_inverse_matches_numpy(rng):
    keys = rng.integers(0, 1 << 35, size=200_000).astype(np.int64)
    keys[:1000] = keys[1000:2000]  # force duplicates
    perm, inv, uni = native.sort_unique_inverse(keys)

    ref_perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(perm, ref_perm)  # incl. stability
    ref_uni, ref_inv = np.unique(keys[ref_perm], return_inverse=True)
    np.testing.assert_array_equal(uni, ref_uni)
    np.testing.assert_array_equal(inv, ref_inv)


def test_block_plan_matches_numpy(rng):
    n, n3 = 50_000, 300
    sbd = rng.integers(0, 4, size=n).astype(np.int32)
    row = rng.integers(0, n3 // 3, size=n).astype(np.int32)
    col = rng.integers(0, n3 // 3, size=n).astype(np.int32)
    perm, inv, uni = native.block_plan(sbd, row, col, n3)

    i3 = np.arange(3, dtype=np.int64)
    dest = (sbd.astype(np.int64)[:, None, None] * (n3 * n3)
            + (row.astype(np.int64)[:, None, None] * 3 + i3[None, :, None]) * n3
            + (col.astype(np.int64)[:, None, None] * 3 + i3[None, None, :]))
    dest = dest.reshape(-1)
    ref_perm = np.argsort(dest, kind="stable")
    np.testing.assert_array_equal(perm, ref_perm)
    ref_uni, ref_inv = np.unique(dest[ref_perm], return_inverse=True)
    np.testing.assert_array_equal(uni, ref_uni)
    np.testing.assert_array_equal(inv, ref_inv)


def test_library_is_generic_and_named_by_its_sources():
    """A library copied to another x86-64 host must load there, and one
    built from other sources is never reused."""
    import os
    import re
    assert not any("march" in f or "mtune" in f for f in native._FLAGS)
    assert re.fullmatch(r"libplanops-[0-9a-f]{12}\.so",
                        os.path.basename(native._so_path()))
    assert native.load() is native.load()


def _no_library():
    raise OSError("native library unavailable")


def test_kway_partition_raises_without_the_library(monkeypatch):
    """No silent switch to RCB: the partition (and so the subdomains and
    iteration counts) would change."""
    import pytest
    from dot_tpu import partition
    from dot_tpu.mesh_gen import bar_mesh
    monkeypatch.setattr(native, "load", _no_library)
    with pytest.raises(OSError):
        partition.element_partition(bar_mesh(8, 3, 3), 4)


def test_plan_helpers_fall_back_to_numpy(monkeypatch, rng):
    keys = rng.integers(0, 1 << 20, size=5000).astype(np.int64)
    want = native.sort_unique_inverse(keys)
    monkeypatch.setattr(native, "load", _no_library)
    got = native.sort_unique_inverse(keys)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_plan_records_its_partitioner():
    from dot_tpu import partition
    from dot_tpu.mesh_gen import bar_mesh
    mesh = bar_mesh(8, 3, 3)
    assert partition.build_plan(mesh, 4, pad_elem_to=16,
                                pad_n3_to=48).partitioner in ("kway", "rcb")
    assert partition.build_plan(mesh, 1, pad_elem_to=16,
                                pad_n3_to=48).partitioner == "single"
