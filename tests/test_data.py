"""Data layer tests: manifest round-trip, tokenizer codec, bucketing shapes,
iterator determinism + resume, multi-dialect mixing."""

import numpy as np
import pytest

from jiao_liao_asr.data import (
    BatchIterator,
    CharTokenizer,
    Manifest,
    ManifestRow,
    read_manifest,
    write_manifest,
)
from jiao_liao_asr.data.pipeline import mix_manifests
from jiao_liao_asr.frontend.audio_io import write_wav
from jiao_liao_asr.utils.config import DataConfig

TEXTS = ["今天天气很好", "我爱北京", "胶辽官话", "语音识别测试"]


@pytest.fixture()
def corpus(tmp_path, rng):
    rows = []
    for i, text in enumerate(TEXTS * 3):
        dur = [1.1, 2.3, 4.5, 0.9][i % 4]
        wav = (rng.randn(int(16000 * dur)) * 0.1).astype(np.float32)
        p = tmp_path / f"utt{i}.wav"
        write_wav(p, wav, 16000)
        rows.append(
            ManifestRow(audio=str(p), text=text, duration=dur, dialect=f"d{i % 2}")
        )
    mpath = tmp_path / "train.jsonl"
    write_manifest(rows, mpath)
    return mpath


def test_manifest_roundtrip(corpus):
    m = read_manifest(corpus)
    assert len(m) == 12
    assert m.rows[0].text == TEXTS[0]
    assert set(m.dialects()) == {"d0", "d1"}
    assert len(m.filter_duration(1.0, 3.0)) == 6


def test_tokenizer_roundtrip():
    tok = CharTokenizer.build(TEXTS)
    for t in TEXTS:
        ids = tok.encode(t)
        assert tok.decode(ids) == t
        assert all(i > 1 for i in ids)
    assert tok.encode("☂")[0] == tok.unk_id  # OOV -> unk
    assert tok.blank_id == 0


def test_tokenizer_save_load(tmp_path):
    tok = CharTokenizer.build(TEXTS)
    tok.save(tmp_path / "vocab.json")
    tok2 = CharTokenizer.load(tmp_path / "vocab.json")
    assert tok2.vocab == tok.vocab


def test_batch_shapes_and_bucketing(corpus):
    m = read_manifest(corpus)
    tok = CharTokenizer.build(m.texts())
    cfg = DataConfig(
        batch_size=3, bucket_boundaries_seconds=(2.0, 5.0), max_text_len=16
    )
    it = BatchIterator(m, tok, cfg)
    for _ in range(6):
        b = next(it)
        assert b.audio.shape[0] <= 3
        assert b.audio.shape[1] == int(b.bucket_seconds * 16000)
        assert (b.audio_lengths <= b.audio.shape[1]).all()
        assert (b.label_lengths > 0).all()


def test_iterator_resume_determinism(corpus):
    m = read_manifest(corpus)
    tok = CharTokenizer.build(m.texts())
    cfg = DataConfig(batch_size=2, bucket_boundaries_seconds=(2.0, 5.0))
    a = BatchIterator(m, tok, cfg)
    seq1 = [next(a).texts for _ in range(8)]
    # resume from the midpoint state
    b = BatchIterator(m, tok, cfg)
    for _ in range(4):
        next(b)
    state = b.state_dict()
    c = BatchIterator(m, tok, cfg)
    c.load_state_dict(state)
    seq2 = [next(c).texts for _ in range(4)]
    assert seq1[4:] == seq2


def test_mix_manifests():
    m1 = Manifest([ManifestRow("a.wav", "一", 1.0, "jiaoliao")] * 4)
    m2 = Manifest([ManifestRow("b.wav", "二", 1.0, "jilu")] * 8)
    mix = mix_manifests({"jl": m1, "jr": m2}, {"jl": 3.0, "jr": 1.0}, seed=0)
    frac = sum(1 for r in mix.rows if r.text == "一") / len(mix.rows)
    assert 0.6 < frac < 0.9  # ~0.75 expected


def test_prefetch_iterator_matches_and_resumes(corpus):
    from jiao_liao_asr.data.pipeline import PrefetchIterator

    m = read_manifest(corpus)
    tok = CharTokenizer.build(m.texts())
    cfg = DataConfig(batch_size=2, bucket_boundaries_seconds=(2.0, 5.0))
    plain = BatchIterator(m, tok, cfg)
    pf = PrefetchIterator(BatchIterator(m, tok, cfg))
    seq_a = [next(plain).texts for _ in range(6)]
    seq_b = [next(pf).texts for _ in range(6)]
    assert seq_a == seq_b
    # resume from prefetcher's consumed-state: replay continues exactly
    state = pf.state_dict()
    pf2 = PrefetchIterator(BatchIterator(m, tok, cfg))
    pf2.load_state_dict(state)
    nxt_plain = [next(plain).texts for _ in range(3)]
    nxt_pf = [next(pf2).texts for _ in range(3)]
    assert nxt_plain == nxt_pf


def test_config_yaml_roundtrip_and_overrides(tmp_path):
    from jiao_liao_asr.utils.config import (
        ExperimentConfig, apply_overrides, load_config, save_config,
    )

    cfg = ExperimentConfig()
    save_config(cfg, str(tmp_path / "c.json"))
    back = load_config(str(tmp_path / "c.json"))
    assert back == cfg

    # override values parse as JSON: "3e-3" is a float, lists are tuples
    cfg2 = apply_overrides(cfg, ["train.optimizer.learning_rate=3e-3",
                                 "ctc_model.num_layers=6",
                                 "data.bucket_boundaries_seconds=[2.0, 4.0]"])
    assert cfg2.train.optimizer.learning_rate == 3e-3
    assert isinstance(cfg2.train.optimizer.learning_rate, float)
    assert cfg2.ctc_model.num_layers == 6
    assert cfg2.data.bucket_boundaries_seconds == (2.0, 4.0)

    import pytest as _pytest

    with _pytest.raises(KeyError):
        apply_overrides(cfg, ["train.optimizzer.lr=1"])


def test_prefetch_propagates_worker_exception(tmp_path):
    """A dead prefetch worker (unreadable audio) must raise in the trainer
    thread, not hang the queue forever."""
    import numpy as np
    import pytest

    from jiao_liao_asr.data.manifest import (
        Manifest,
        ManifestRow,
    )
    from jiao_liao_asr.data.pipeline import (
        BatchIterator,
        PrefetchIterator,
    )
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.utils.config import DataConfig

    rows = [
        ManifestRow(audio=str(tmp_path / "missing.wav"), text="你好", duration=1.0)
    ]
    cfg = DataConfig(batch_size=1, bucket_boundaries_seconds=[2.0], max_text_len=4)
    it = PrefetchIterator(
        BatchIterator(
            Manifest(rows), CharTokenizer.build(["你好"]), cfg,
            drop_last=False, process_index=0, process_count=1,
        )
    )
    with pytest.raises(RuntimeError, match="prefetch worker died"):
        next(it)


def test_int16_wire_format_matches_float32(corpus):
    """transfer_dtype='int16' ships native PCM; dequantizing on device must
    reproduce the float32 path bit-for-bit for 16-bit-sourced WAV."""
    import jax.numpy as jnp

    from jiao_liao_asr.frontend.features import dequantize_pcm

    m = read_manifest(corpus)
    tok = CharTokenizer.build(m.texts())
    kw = dict(batch_size=3, bucket_boundaries_seconds=(2.0, 5.0), max_text_len=16)
    it_f32 = BatchIterator(m, tok, DataConfig(**kw), shuffle=False)
    it_i16 = BatchIterator(
        m, tok, DataConfig(transfer_dtype="int16", **kw), shuffle=False
    )
    for _ in range(4):
        bf, bi = next(it_f32), next(it_i16)
        assert bi.audio.dtype == np.int16
        assert bf.audio.dtype == np.float32
        deq = np.asarray(dequantize_pcm(jnp.asarray(bi.audio)))
        np.testing.assert_array_equal(deq, bf.audio)
        np.testing.assert_array_equal(bi.audio_lengths, bf.audio_lengths)
    with pytest.raises(ValueError, match="transfer_dtype"):
        BatchIterator(m, tok, DataConfig(transfer_dtype="fp8", **kw))
