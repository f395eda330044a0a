"""External-LM shallow fusion (decode/lm.py): n-gram scoring, persistence,
host CTC beam fusion, and on-device AR beam fusion."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.data.tokenizer import CharTokenizer
from jiao_liao_asr.decode.ctc import ctc_prefix_beam_search_host
from jiao_liao_asr.decode.lm import NGramCharLM

TEXTS = ["你好世界", "你好胶辽", "你好世界真好", "世界你好"] * 5


@pytest.fixture(scope="module")
def lm_and_tok():
    tok = CharTokenizer.build(TEXTS)
    lm = NGramCharLM.train_from_texts(TEXTS, tok, order=3)
    return lm, tok


def test_lm_scores_likely_sequences_higher(lm_and_tok):
    lm, tok = lm_and_tok
    likely = lm.score_sequence(tok.encode("你好世界"))
    unlikely = lm.score_sequence(tok.encode("界世好你"))
    assert likely > unlikely


def test_lm_backoff_handles_unseen(lm_and_tok):
    lm, tok = lm_and_tok
    ids = tok.encode("你好")
    # unseen trigram context backs off instead of -inf / KeyError
    s = lm.logp([ids[1], ids[0]], ids[0])
    assert np.isfinite(s) and s < 0


def test_lm_save_load_roundtrip(lm_and_tok, tmp_path):
    lm, tok = lm_and_tok
    p = tmp_path / "lm.npz"
    lm.save(p)
    lm2 = NGramCharLM.load(p)
    ids = tok.encode("你好世界")
    assert abs(lm.score_sequence(ids) - lm2.score_sequence(ids)) < 1e-9
    assert lm2.order == lm.order and lm2.vocab_size == lm.vocab_size


def test_host_beam_fusion_flips_ambiguous_decode(lm_and_tok):
    """Acoustically ambiguous frame: the LM prefers the in-domain char."""
    lm, tok = lm_and_tok
    a, b = tok.encode("你好")  # '你' then '好'
    V = len(tok)
    T = 4
    lp = np.full((1, T, V), np.log(1e-4), np.float32)
    # frame 0+1: clearly '你'; frame 2+3: nearly tied between '好' (seen
    # bigram 你好) and '世' (never follows 你), tilted toward the WRONG one
    c = tok.encode("世界")[0]
    lp[0, 0, a] = lp[0, 1, a] = np.log(0.9)
    for t in (2, 3):
        lp[0, t, b] = np.log(0.44)
        lp[0, t, c] = np.log(0.46)
    lens = np.asarray([T])
    ids0, n0 = ctc_prefix_beam_search_host(lp, lens, beam_size=4)
    assert tok.decode(ids0[0][: n0[0]]) == "你世"
    ids1, n1 = ctc_prefix_beam_search_host(
        lp, lens, beam_size=4, lm=lm, lm_weight=0.8
    )
    assert tok.decode(ids1[0][: n1[0]]) == "你好"
    # zero weight is bit-identical to no LM
    ids2, n2 = ctc_prefix_beam_search_host(lp, lens, beam_size=4, lm=lm, lm_weight=0.0)
    assert (ids2 == ids0).all() and (n2 == n0).all()


def test_bigram_matrix_matches_logp(lm_and_tok):
    lm, tok = lm_and_tok
    mat = lm.bigram_log_matrix()
    assert mat.shape == (len(tok), len(tok))
    a, b = tok.encode("你好")
    assert abs(mat[a, b] - lm.logp([a], b)) < 1e-6


def test_device_beam_fusion_biases_whisper(tmp_path):
    """beam_generate with a bigram matrix biases token choice on device."""
    from jiao_liao_asr.decode.whisper_generate import beam_generate
    from jiao_liao_asr.models.whisper import WhisperModel
    from jiao_liao_asr.utils.config import WhisperConfig

    cfg = WhisperConfig(
        vocab_size=32, d_model=32, encoder_layers=1, decoder_layers=1,
        num_heads=2, mlp_dim=64, max_target_positions=16, dtype="float32",
    )
    model = WhisperModel(cfg)
    mel = jnp.asarray(np.random.RandomState(0).randn(1, 80, 40).astype(np.float32))
    toks = jnp.zeros((1, 4), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), mel, toks)["params"]
    prompt, eot = (1,), 2
    base, _ = beam_generate(model, params, mel, beam_size=2, max_len=8,
                            prompt=prompt, eot_id=eot)
    # an LM matrix that massively prefers token 7 everywhere
    mat = np.full((32, 32), -10.0, np.float32)
    mat[:, 7] = 0.0
    fused, _ = beam_generate(model, params, mel, beam_size=2, max_len=8,
                             prompt=prompt, eot_id=eot,
                             lm_bigram=jnp.asarray(mat), lm_weight=5.0)
    assert (np.asarray(fused) == 7).mean() > 0.8
    assert not (np.asarray(base) == np.asarray(fused)).all()
