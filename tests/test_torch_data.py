"""The port's synthetic data pipelines (``repro_torch.data``) against the
JAX package's: the same batches byte for byte, host sharding, and the
prefetcher."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.data as jdata  # noqa: E402

import repro_torch.data as data  # noqa: E402

CASES = [(0, 0, 0, 1), (3, 7, 0, 1), (3, 5000, 1, 2), (11, 2, 3, 4)]


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("seed,index,host_index,host_count", CASES)
def test_image_batches_are_jaxs_byte_for_byte(seed, index, host_index,
                                              host_count):
    kw = dict(image_size=12, n_classes=5, global_batch=8, seed=seed,
              host_index=host_index, host_count=host_count)
    got = data.SyntheticImagePipeline(data.ImagePipelineConfig(**kw))
    want = jdata.SyntheticImagePipeline(jdata.ImagePipelineConfig(**kw))
    _assert_same(got.batch(index), want.batch(index))
    assert got.batch(index)["images"].shape == (8 // host_count, 12, 12, 3)


@pytest.mark.parametrize("seed,index,host_index,host_count", CASES)
def test_token_batches_are_jaxs_byte_for_byte(seed, index, host_index,
                                              host_count):
    kw = dict(vocab_size=50, seq_len=9, global_batch=8, seed=seed,
              host_index=host_index, host_count=host_count)
    got = data.SyntheticTokenPipeline(data.TokenPipelineConfig(**kw))
    want = jdata.SyntheticTokenPipeline(jdata.TokenPipelineConfig(**kw))
    _assert_same(got.batch(index), want.batch(index))
    b = got.batch(index)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_hosts_draw_their_own_slices():
    cfgs = [data.ImagePipelineConfig(8, 4, global_batch=6, seed=2,
                                     host_index=h, host_count=3)
            for h in range(3)]
    batches = [data.SyntheticImagePipeline(c).batch(4) for c in cfgs]
    assert all(b["images"].shape[0] == 2 for b in batches)
    for a in range(3):
        for b in range(a + 1, 3):
            assert not np.array_equal(batches[a]["images"],
                                      batches[b]["images"])
    # a batch is a pure function of (seed, index, host): a new pipeline
    # reproduces it
    again = data.SyntheticImagePipeline(cfgs[1]).batch(4)
    _assert_same(again, batches[1])
    with pytest.raises(AssertionError):
        data.SyntheticImagePipeline(data.ImagePipelineConfig(
            8, 4, global_batch=7, host_count=3))


def test_prefetcher_yields_the_stream_in_order():
    pipe = data.SyntheticTokenPipeline(data.TokenPipelineConfig(
        vocab_size=20, seq_len=4, global_batch=2, seed=1))
    pf = data.Prefetcher(pipe, depth=2, start_index=3)
    try:
        for i in range(3, 8):
            _assert_same(pf.next(), pipe.batch(i))
    finally:
        pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()


def test_iteration_walks_the_indices():
    pipe = data.SyntheticImagePipeline(data.ImagePipelineConfig(
        8, 3, global_batch=2, seed=9))
    it = iter(pipe)
    for i in range(3):
        _assert_same(next(it), pipe.batch(i))
