"""The port's flash tile table (``paddle_tpu_torch/ops/hopper/autotune.py``)
against the reference's ``paddle_tpu/ops/pallas/autotune.py``, on the CPU.

``_pick_block`` and ``_bucket_seq`` are copies and must agree with the
reference's everywhere; the measured cache persists to the file named by
``PADDLE_TPU_AUTOTUNE_CACHE`` as the reference's does; ``get_flash_blocks``
returns only tile pairs that a compiled instance takes (the C dispatch
refuses any other), and the flash wrapper's tile selection follows the
explicit (dtype, D, tile) table: bfloat16 -> a tensor-core pair, float32
-> the SIMT instance's pair, anything else raises.  Timing (``tune``) needs
the card and runs in ``chip_smoke.py``.
"""
import json

import pytest
import torch

from paddle_tpu.ops.pallas import autotune as ref
from paddle_tpu_torch.ops.hopper import autotune as at
from paddle_tpu_torch.ops.hopper import flash_attention as fa


@pytest.fixture
def fresh_cache(monkeypatch, tmp_path):
    """An empty measured cache that reloads from a file of this test."""
    path = tmp_path / "flash_tiles.json"
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(path))
    monkeypatch.setattr(at, "_measured", {})
    monkeypatch.setattr(at, "_cache_loaded", False)
    return path


def test_bucket_seq_is_the_reference():
    for s in list(range(1, 600)) + [1023, 1024, 1025, 2047, 2048, 4096,
                                    8191, 8192, 10000]:
        assert at._bucket_seq(s) == ref._bucket_seq(s), s


def test_pick_block_is_the_reference():
    for s in list(range(1, 300)) + [512, 700, 1000, 2048, 3000]:
        for target in (1, 8, 64, 128, 256, 512):
            assert at._pick_block(s, target) == ref._pick_block(s, target), (
                s, target)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq", [1, 96, 128, 2048])
def test_get_flash_blocks_returns_a_compiled_pair(fresh_cache, kind, d, sq):
    for sk in (sq, 64, 700, 4096):
        pair = at.get_flash_blocks(kind, sq, sk, d)
        assert pair in at.INSTANCES[(kind, d)], (kind, sq, sk, d, pair)
        # never a query tile taller than the sequence needs
        if sq <= 64:
            assert pair[0] == 64


def test_head_dim_class_rounds_up_to_the_instances():
    assert [at.head_dim_class(d) for d in (16, 64, 80, 128, 144, 256)] == [
        64, 64, 128, 128, 256, 256]
    for bad in (0, 24, 272):
        with pytest.raises(ValueError):
            at.head_dim_class(bad)
    # a D between the classes takes its class's instances
    assert at.get_flash_blocks("fwd", 2048, 2048, 80) in at.INSTANCES[
        ("fwd", 128)]


def test_measured_cache_round_trip_and_clear(fresh_cache):
    key = ("fwd", 2048, 2048, 128)
    assert at.get_flash_blocks("fwd", 2048, 2048, 128) != (64, 64)
    at._measured[key] = (64, 64)
    at._save_cache()
    saved = json.loads(fresh_cache.read_text())
    assert saved == {json.dumps(list(key)): [64, 64]}
    # a new process: nothing measured, the file read on first use
    at._measured.clear()
    at._cache_loaded = False
    assert at.get_flash_blocks("fwd", 2048, 2048, 128) == (64, 64)
    assert at._measured == {key: (64, 64)}
    # the bucket key: another length of the same magnitude hits it too
    assert at.get_flash_blocks("fwd", 3000, 3000, 128) == (64, 64)
    at.clear_cache()
    assert at._measured == {}
    assert at.get_flash_blocks("fwd", 2048, 2048, 128) == \
        at._DEFAULT_TARGETS[("fwd", 128)]


def test_a_measured_pair_is_capped_at_the_sequence(fresh_cache):
    at._measured[("fwd", 64, 64, 128)] = (128, 128)
    assert at.get_flash_blocks("fwd", 64, 64, 128) == (64, 64)


def test_tune_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tune() runs in chip_smoke.py")
    with pytest.raises(RuntimeError):
        at.tune(seqs=(128,), head_dims=(64,))


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_wrapper_tiles_follow_the_dtype_table(fresh_cache, kind):
    sel = fa._select_blocks
    for d in (64, 128, 256):
        assert sel("f", kind, torch.bfloat16, 2048, 2048, d) == \
            at.get_flash_blocks(kind, 2048, 2048, d)
        assert sel("f", kind, torch.float32, 2048, 2048, d) == \
            at.SIMT_TILES[kind](d)
        for pair in at.INSTANCES[(kind, at.head_dim_class(d))]:
            assert sel("f", kind, torch.bfloat16, 128, 128, d, pair) == pair
        # no instance: refused before any launch
        with pytest.raises(ValueError, match="no bfloat16"):
            sel("f", kind, torch.bfloat16, 128, 128, d, (32, 32))
        with pytest.raises(ValueError, match="float32 instance"):
            sel("f", kind, torch.float32, 128, 128, d, (128, 128))
    with pytest.raises(TypeError):
        sel("f", kind, torch.float16, 128, 128, 64)


def test_gqa_mode_follows_the_grid_size():
    # one head per block (partials) while a block per KV head underfills
    # the card; a block walks its group once the grid is large
    assert fa._gqa_heads_per_block(1, 8, 512, 4) == 1
    assert fa._gqa_heads_per_block(8, 8, 2048, 4) == 4
    assert fa._gqa_heads_per_block(8, 32, 2048, 1) == 1
