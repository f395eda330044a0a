"""Streaming CTC transcription (serve/streaming.py).

What must hold:

* plumbing exactness — an utterance that fits in one window must produce,
  via finish(), byte-identical text to the offline ModelBundle.transcribe
  greedy path (same features, same length mask, same collapse semantics);
* chunk-size invariance — how the caller slices the audio into feed()
  calls must not change the result;
* commit bookkeeping — with a deterministic fake window-step whose frame
  ids are a pure function of GLOBAL frame index, the streamed token
  sequence must equal the offline collapse of that function for every
  (window, hop, lookahead) combination: no frame skipped, double-committed,
  or collapsed with the wrong carry across window boundaries;
* the joint family's CTC branch streams through the same machinery;
* loud validation errors (whisper family, misaligned hop, window too small,
  feed after finish).
"""

import numpy as np
import pytest

from jiao_liao_asr.data.tokenizer import CharTokenizer
from jiao_liao_asr.models.bundle import ModelBundle
from jiao_liao_asr.serve.streaming import (
    StreamingConfig,
    StreamingPool,
    StreamingTranscriber,
)
from jiao_liao_asr.utils.config import (
    CTCModelConfig,
    ExperimentConfig,
    JointModelConfig,
)

SR = 16000
ALIGN = 640  # hop_length 160 * subsample 4


def _ctc_bundle(vocab_size=8):
    cfg = ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(
            vocab_size=vocab_size, d_model=32, num_layers=2, num_heads=2,
            mlp_dim=64, conv_channels=16, dropout=0.0,
        ),
    )
    cfg.frontend.chunk_seconds = 2.56  # == streaming window for exactness
    params = ModelBundle._init_params(cfg)
    vocab = [chr(0x4E00 + i) for i in range(vocab_size - 2)]
    return ModelBundle(config=cfg, params=params, tokenizer=CharTokenizer(vocab))


def _audio(seconds, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(SR * seconds)) * 0.1).astype(np.float32)


# ---------------------------------------------------------------- exactness
def test_finish_matches_offline_single_window():
    bundle = _ctc_bundle()
    audio = _audio(1.28)
    offline = bundle.transcribe(audio)[0]
    st = StreamingTranscriber(
        bundle, StreamingConfig(window_seconds=2.56, hop_seconds=2.56,
                                lookahead_seconds=0.0),
    )
    st.feed(audio)
    res = st.finish()
    assert res.is_final and res.preview == ""
    assert res.text == offline


def test_chunk_size_invariance():
    bundle = _ctc_bundle()
    audio = _audio(3.2, seed=1)
    sc = StreamingConfig(window_seconds=1.28, hop_seconds=0.32,
                         lookahead_seconds=0.16)

    def run(chunks):
        st = StreamingTranscriber(bundle, sc)
        partials = []
        for c in chunks:
            partials.append(st.feed(c).text)
            # committed text only grows (it is final by contract)
            assert partials[-1].startswith(partials[-2] if len(partials) > 1 else "")
        final = st.finish()
        return st._tokens, final.text, partials[-1]

    one_tokens, one_text, _ = run([audio])
    rng = np.random.RandomState(7)
    cuts = np.sort(rng.randint(1, len(audio), size=9))
    many_tokens, many_text, many_partial = run(np.split(audio, cuts))
    assert one_tokens == many_tokens
    assert one_text == many_text
    assert many_text.startswith(many_partial)


# ---------------------------------------------------- commit bookkeeping
def _fake_step(params, wav, nframes):
    """Deterministic window step: frame id = round(1000 * sample at the
    frame's first sample). The test encodes the GLOBAL frame index into the
    audio, so any window/offset bug shows up as a wrong or missing token."""
    wav = np.asarray(wav)
    n = int(np.asarray(nframes)[0])
    out_len = (n + 1) // 2
    out_len = (out_len + 1) // 2
    ids = np.rint(wav[0, ::ALIGN] * 1000.0).astype(np.int32)
    return ids[None, :], np.asarray([out_len], np.int32)


def _frame_id(e):
    # runs of 3 with blanks interleaved: 1,1,1, 2,2,2, 0,0,0, 3,3,3, ...
    r = (e // 3) % 5
    return 0 if r == 4 else r + 1


def _collapse(ids, blank=0):
    out, prev = [], -1
    for t in ids:
        if t != blank and t != prev:
            out.append(t)
        prev = t
    return out


@pytest.mark.parametrize(
    "window,hop,look,n_align,tail",
    [
        (2.56, 0.32, 0.16, 40, 0),     # steady-state sliding
        (2.56, 0.32, 0.0, 40, 300),    # zero lookahead + ragged tail
        (1.28, 0.64, 0.48, 17, 639),   # deep lookahead, tail just short
        (2.56, 2.56, 0.0, 11, 100),    # hop == window (block mode)
    ],
)
def test_commit_bookkeeping_fake_step(window, hop, look, n_align, tail):
    bundle = _ctc_bundle()
    st = StreamingTranscriber(
        bundle, StreamingConfig(window_seconds=window, hop_seconds=hop,
                                lookahead_seconds=look),
    )
    st._step = _fake_step
    total = n_align * ALIGN + tail
    audio = np.zeros(total, np.float32)
    for n in range(total):
        audio[n] = _frame_id(n // ALIGN) / 1000.0

    rng = np.random.RandomState(3)
    cuts = np.sort(rng.randint(1, total, size=6))
    committed_before = 0
    for c in np.split(audio, cuts):
        res = st.feed(c)
        assert res.committed_frames >= committed_before  # monotone commits
        committed_before = res.committed_frames
    res = st.finish()

    n_mel = total // 160
    n_frames = ((n_mel + 1) // 2 + 1) // 2
    expected = _collapse([_frame_id(e) for e in range(n_frames)])
    assert st._tokens == expected
    assert res.committed_frames == n_frames


def test_trailing_silence_endpoint_signal():
    """trailing_silence tracks committed blank frames since the last voice
    commit — the auto-finalize signal for a serving layer."""
    bundle = _ctc_bundle()
    st = StreamingTranscriber(
        bundle, StreamingConfig(window_seconds=2.56, hop_seconds=0.32,
                                lookahead_seconds=0.0),
    )
    st._step = _fake_step
    # voice for the first 20 frames, silence afterwards
    total = 60 * ALIGN
    audio = np.zeros(total, np.float32)
    for n in range(20 * ALIGN):
        audio[n] = ((n // ALIGN) % 3 + 1) / 1000.0
    res = st.feed(audio[: 24 * ALIGN])
    assert res.trailing_silence == pytest.approx(4 * ALIGN / SR, abs=1e-6)
    res = st.feed(audio[24 * ALIGN :])
    # 60 frames fed but hops are 8 frames: 56 committed, 36 of them silent
    assert res.trailing_silence == pytest.approx(36 * ALIGN / SR, abs=1e-6)
    assert st.finish().trailing_silence == pytest.approx(40 * ALIGN / SR, abs=1e-6)


# ------------------------------------------------------------ joint family
def test_joint_family_streams_ctc_branch():
    cfg = ExperimentConfig(
        model_family="joint",
        joint=JointModelConfig(
            vocab_size=8, d_model=32, num_layers=2, decoder_layers=1,
            num_heads=2, mlp_dim=64, conv_channels=16,
            dropout=0.0,
        ),
    )
    cfg.frontend.chunk_seconds = 1.28
    cfg.decode.strategy = "ctc_greedy"
    params = ModelBundle._init_params(cfg)
    bundle = ModelBundle(
        config=cfg, params=params,
        tokenizer=CharTokenizer([chr(0x4E00 + i) for i in range(6)]),
    )
    audio = _audio(0.96, seed=2)
    offline = bundle.transcribe(audio)[0]
    st = StreamingTranscriber(
        bundle, StreamingConfig(window_seconds=1.28, hop_seconds=1.28,
                                lookahead_seconds=0.0),
    )
    st.feed(audio)
    assert st.finish().text == offline


# --------------------------------------------------------------- api facade
def test_api_stream_facade():
    """api.stream yields a result per chunk plus a final one, and the final
    text equals the transcriber driven directly."""
    from jiao_liao_asr import stream

    bundle = _ctc_bundle()
    sc = StreamingConfig(window_seconds=1.28, hop_seconds=0.32,
                         lookahead_seconds=0.16)
    audio = _audio(1.6, seed=9)
    chunks = np.split(audio, 4)

    st = StreamingTranscriber(bundle, sc)
    st.feed(audio)
    want = st.finish().text

    results = list(stream(bundle, chunks, sc))
    assert len(results) == 5 and results[-1].is_final
    assert all(not r.is_final for r in results[:-1])
    assert results[-1].text == want


# -------------------------------------------------------------------- pool
def _f32_bundle():
    # float32 compute: batched rows must equal single-row dispatches exactly,
    # without bf16 tie-flip noise between the [N, W] and [1, W] programs
    b = _ctc_bundle()
    b.config.ctc_model.dtype = "float32"
    return b


@pytest.mark.parametrize("device_ring", [True, False])
def test_pool_matches_single_stream(device_ring):
    bundle = _f32_bundle()
    sc = StreamingConfig(window_seconds=1.28, hop_seconds=0.32,
                         lookahead_seconds=0.16)
    audios = [_audio(s, seed=i) for i, s in enumerate([1.6, 0.88, 2.4])]

    singles = []
    for a in audios:
        st = StreamingTranscriber(bundle, sc)
        st.feed(a)
        singles.append(st.finish().text)

    pool = StreamingPool(bundle, slots=4, stream_cfg=sc,
                         device_ring=device_ring)
    sids = [pool.open() for _ in audios]
    # staggered real-time arrival: feed hop-sized pieces, stepping between
    hop = int(0.32 * SR)
    offs = [0, 0, 0]
    done = {}
    while len(done) < len(audios):
        for k, sid in enumerate(sids):
            if sid in done:
                continue
            if offs[k] < len(audios[k]):
                pool.feed(sid, audios[k][offs[k] : offs[k] + hop])
                offs[k] += hop
            else:
                done[sid] = pool.finish(sid).text
        for res in pool.step().values():
            assert isinstance(res.text, str)
    assert [done[s] for s in sids] == singles


def test_pool_finish_drains_backlog():
    bundle = _f32_bundle()
    sc = StreamingConfig(window_seconds=1.28, hop_seconds=0.32,
                         lookahead_seconds=0.16)
    audio = _audio(3.2, seed=5)  # 2.5 windows of backlog
    st = StreamingTranscriber(bundle, sc)
    st.feed(audio)
    want = st.finish().text

    pool = StreamingPool(bundle, slots=2, stream_cfg=sc)
    sid = pool.open()
    pool.feed(sid, audio)  # buffered only — no step() calls at all
    assert pool.finish(sid).text == want


def test_pool_ring_row_reuse_no_leak():
    """A freed ring row must be zeroed for the next stream: stream B on a
    reused row must transcribe identically to a fresh pool's stream B."""
    bundle = _f32_bundle()
    sc = StreamingConfig(window_seconds=1.28, hop_seconds=0.32,
                         lookahead_seconds=0.16)
    a, b = _audio(1.6, seed=11), _audio(0.8, seed=12)

    pool = StreamingPool(bundle, slots=1, stream_cfg=sc, device_ring=True)
    sa = pool.open()
    pool.feed(sa, a)
    while pool.step():
        pass
    pool.finish(sa)
    sb = pool.open()  # reuses row 0, whose ring holds stream A's audio
    pool.feed(sb, b)
    while pool.step():
        pass
    got = pool.finish(sb).text

    fresh = StreamingPool(bundle, slots=1, stream_cfg=sc, device_ring=True)
    sid = fresh.open()
    fresh.feed(sid, b)
    while fresh.step():
        pass
    assert fresh.finish(sid).text == got


def test_pool_slot_limit():
    bundle = _ctc_bundle()
    pool = StreamingPool(
        bundle, slots=1,
        stream_cfg=StreamingConfig(window_seconds=1.28, hop_seconds=0.32,
                                   lookahead_seconds=0.16),
    )
    a = pool.open()
    with pytest.raises(RuntimeError, match="full"):
        pool.open()
    pool.finish(a)
    pool.open()  # freed slot is reusable


# -------------------------------------------------------------- validation
def test_validation_errors():
    bundle = _ctc_bundle()
    with pytest.raises(ValueError, match="multiples"):
        StreamingTranscriber(bundle, StreamingConfig(hop_seconds=0.05))
    with pytest.raises(ValueError, match="cover"):
        StreamingTranscriber(
            bundle, StreamingConfig(window_seconds=0.64, hop_seconds=0.32,
                                    lookahead_seconds=0.64),
        )
    st = StreamingTranscriber(bundle, StreamingConfig(
        window_seconds=1.28, hop_seconds=0.32, lookahead_seconds=0.2))
    st.feed(_audio(0.2))
    st.finish()
    with pytest.raises(RuntimeError, match="finished"):
        st.feed(_audio(0.1))

    from jiao_liao_asr.utils.config import WhisperConfig

    wcfg = ExperimentConfig(
        model_family="whisper",
        whisper=WhisperConfig(
            vocab_size=16, d_model=32, encoder_layers=1, decoder_layers=1,
            num_heads=2, mlp_dim=64, max_source_positions=16,
            max_target_positions=8, ),
    )
    wb = ModelBundle(
        config=wcfg, params=None, tokenizer=CharTokenizer([]),
    )
    with pytest.raises(ValueError, match="whisper"):
        StreamingTranscriber(wb)
