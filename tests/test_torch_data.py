"""The port's data pipeline against the JAX package's: the token-file
source gives the same batches token for token (both draw the step's file
offsets from numpy seeded by (seed, step)); the synthetic stream is a pure
function of (seed, step) with the JAX stream's structure (its bits come
from a ``torch.Generator``, not ``jax.random``: ROADMAP, deliberate
divergences); the iterator resumes by seeking."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import DataIterator as JaxDataIterator
from repro_torch.data.pipeline import DataConfig, DataIterator, TokenFileSource, synthetic_batch


@pytest.mark.parametrize("seed", [0, 7])
def test_token_file_source_matches_jax(tmp_path, seed):
    toks = (np.arange(10_000, dtype=np.uint32) * 2654435761 % 100_003).astype(np.uint32)
    path = tmp_path / "tokens.bin"
    toks.tofile(path)
    kw = dict(vocab_size=512, seq_len=32, global_batch=4, seed=seed, token_file=str(path))
    jit, tit = JaxDataIterator(JaxDataConfig(**kw)), DataIterator(DataConfig(**kw), device="cpu")
    for _ in range(4):
        jb, tb = next(jit), next(tit)
        for key in ("tokens", "targets"):
            assert tb[key].dtype == torch.int32
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    src = TokenFileSource(str(path))
    b = src.batch(DataConfig(**kw), 3, device="cpu")
    np.testing.assert_array_equal(b["targets"][:, :-1].numpy(), b["tokens"][:, 1:].numpy())


def test_synthetic_batch_is_a_pure_function_of_seed_and_step():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=3)
    a, b = synthetic_batch(cfg, 7, device="cpu"), synthetic_batch(cfg, 7, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["targets"], b["targets"])
    assert not torch.equal(a["tokens"], synthetic_batch(cfg, 8, device="cpu")["tokens"])
    other = DataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=4)
    assert not torch.equal(a["tokens"], synthetic_batch(other, 7, device="cpu")["tokens"])
    assert a["tokens"].shape == (4, 16) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])


def test_synthetic_stream_has_the_jax_structure():
    """Tokens in range; about 90% of the steps follow t + 31 mod V (the
    rest is uniform noise, as in JAX's stream)."""
    cfg = DataConfig(vocab_size=1000, seq_len=256, global_batch=16, seed=1)
    t = synthetic_batch(cfg, 0, device="cpu")["tokens"].long()
    assert int(t.min()) >= 0 and int(t.max()) < 1000
    follows = ((t[:, 1:] - t[:, :-1]) % 1000 == 31).float().mean()
    assert 0.75 < float(follows) < 0.9


def test_iterator_seek_resume():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=2)
    it = DataIterator(cfg, device="cpu")
    seq = [next(it) for _ in range(5)]
    it2 = DataIterator(cfg, start_step=3, device="cpu")
    assert torch.equal(seq[3]["tokens"], next(it2)["tokens"])
    it.seek(1)
    assert torch.equal(seq[1]["tokens"], next(it)["tokens"])


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = DataConfig(vocab_size=16, seq_len=4, global_batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_batch(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataIterator(cfg)
