"""Command-line interface: train / transcribe / evaluate / featurize / bench.

Replaces the reference's recipe entry scripts + HyperPyYAML CLIs
(SURVEY.md L6): `python -m jiao_liao_asr.cli <cmd>
--config configs/x.json [key.subkey=value ...]`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _load_config(args):
    from .utils.config import ExperimentConfig, apply_overrides, load_config

    cfg = load_config(args.config) if args.config else ExperimentConfig()
    if args.override:
        cfg = apply_overrides(cfg, args.override)
    return cfg


def cmd_train(args) -> int:
    if getattr(args, "multihost", False):
        # must happen before any jax backend use (SURVEY C19: the
        # reference's `accelerate launch` process-group init equivalent)
        from .parallel.multihost import initialize

        initialize()
    from .api import fine_tune
    from .train.schedules import run_stages
    from .utils.profiling import trace

    cfg = _load_config(args)
    with trace(getattr(args, "profile", None)):
        return _train_body(args, cfg, fine_tune, run_stages)


def _train_body(args, cfg, fine_tune, run_stages) -> int:
    if cfg.stages:
        params, tokenizer, history = run_stages(cfg, resume=args.resume)
        for h in history:
            print(json.dumps(h, ensure_ascii=False))
        # persist the final bundle
        from .models.bundle import ModelBundle

        out = Path(cfg.train.checkpoint_dir) / "final"
        ModelBundle(config=cfg, params=params, tokenizer=tokenizer).save(str(out))
        print(f"saved final bundle to {out}")
    else:
        state, bundle = fine_tune(cfg, resume=args.resume)
        out = Path(cfg.train.checkpoint_dir) / "final"
        bundle.save(str(out))
        print(f"saved final bundle to {out} (step {int(state.step)})")
    return 0


def cmd_transcribe(args) -> int:
    import dataclasses

    from .api import load, transcribe
    from .utils.profiling import trace

    bundle = load(checkpoint=args.checkpoint, config=args.config)
    if getattr(args, "int8", False):
        # weight-only int8 decoder for memory-bound AR serving (whisper family;
        # ModelBundle.quantize, ops/quant.py)
        try:
            bundle = bundle.quantize()
        except NotImplementedError as e:
            print(f"error: --int8: {e}", file=sys.stderr)
            return 2
    decode_cfg = bundle.config.decode
    if args.strategy or args.beam_size is not None:
        decode_cfg = dataclasses.replace(
            decode_cfg,
            strategy=args.strategy or decode_cfg.strategy,
            beam_size=args.beam_size if args.beam_size is not None
            else decode_cfg.beam_size,
        )
    if getattr(args, "stream", False):
        return _transcribe_streaming(bundle, args)
    if getattr(args, "caption", None):
        # subtitle sidecar files from the per-token spans (utils/captions.py);
        # cues are built from word units so a split never lands inside a word
        from .utils.captions import (
            format_srt,
            format_vtt,
            group_cues,
            group_words,
        )

        timed = bundle.transcribe_timed(args.audio)
        fmt = format_srt if args.caption == "srt" else format_vtt
        for path, toks in zip(args.audio, timed):
            units = [
                {"token": w["word"], "start": w["start"], "end": w["end"]}
                for w in group_words(toks)
            ]
            out_path = os.path.splitext(path)[0] + "." + args.caption
            with open(out_path, "w", encoding="utf-8") as f:
                f.write(fmt(group_cues(units)))
            print(json.dumps(
                {"audio": path, "caption": out_path,
                 "text": "".join(t["token"] for t in toks)},
                ensure_ascii=False,
            ))
        return 0
    if getattr(args, "timestamps", False):
        # per-token spans: CTC frame alignment (ctc/joint) or whisper
        # cross-attention DTW (decode/align.py); word spans use the same
        # jieba segmentation WER scores (utils/captions.group_words)
        from .utils.captions import group_words

        timed = bundle.transcribe_timed(args.audio)
        for path, toks in zip(args.audio, timed):
            print(json.dumps(
                {"audio": path,
                 "text": "".join(t["token"] for t in toks),
                 "tokens": toks,
                 "words": group_words(toks)},
                ensure_ascii=False,
            ))
        return 0
    with trace(getattr(args, "profile", None)):
        texts = transcribe(bundle, args.audio, decode_cfg=decode_cfg)
    for path, text in zip(args.audio, texts):
        print(json.dumps({"audio": path, "text": text}, ensure_ascii=False))
    return 0


def _transcribe_streaming(bundle, args) -> int:
    """Simulate a live stream: feed each file hop-by-hop through the
    sliding-window transcriber, emitting a partial-result JSON line per hop
    (committed text + unstable preview) and a final line per file."""
    from .serve.streaming import StreamingConfig, StreamingTranscriber

    sc = StreamingConfig(
        window_seconds=args.stream_window,
        hop_seconds=args.stream_hop,
        lookahead_seconds=args.stream_lookahead,
    )
    for path in args.audio:
        audio, _ = bundle._collect_audio(path, None)
        pcm = audio[0]
        st = StreamingTranscriber(bundle, sc)
        hop = int(sc.hop_seconds * bundle.config.frontend.sample_rate)
        for s in range(0, len(pcm), hop):
            res = st.feed(pcm[s : s + hop])
            print(
                json.dumps(
                    {"audio": path, "t": round((s + hop) / 16000.0, 2),
                     "partial": res.text, "preview": res.preview},
                    ensure_ascii=False,
                ),
                flush=True,
            )
        res = st.finish()
        print(json.dumps({"audio": path, "text": res.text}, ensure_ascii=False))
    return 0


def cmd_evaluate(args) -> int:
    import dataclasses

    from .api import load
    from .data.manifest import read_manifest
    from .evals import corpus_cer, corpus_wer

    bundle = load(checkpoint=args.checkpoint, config=args.config)
    if getattr(args, "int8", False):
        # measure the serving quantization's CER/WER cost vs the bf16 tree
        try:
            bundle = bundle.quantize()
        except NotImplementedError as e:
            print(f"error: --int8: {e}", file=sys.stderr)
            return 2
    decode_cfg = dataclasses.replace(
        bundle.config.decode, strategy=args.decode, beam_size=args.beam_size,
        lm_path=args.lm_path or bundle.config.decode.lm_path,
        lm_weight=args.lm_weight if args.lm_weight is not None
        else bundle.config.decode.lm_weight,
    )
    manifest = read_manifest(args.manifest)
    refs, hyps = [], []
    B = args.batch_size
    rows = manifest.rows
    for i in range(0, len(rows), B):
        chunk = rows[i : i + B]
        hyps.extend(
            bundle.transcribe([r.audio for r in chunk], decode_cfg=decode_cfg)
        )
        refs.extend(r.text for r in chunk)
    result = {
        "cer": corpus_cer(refs, hyps),
        "wer": corpus_wer(refs, hyps),
        "utterances": len(refs),
    }
    if getattr(args, "per_utt", None):
        # per-utterance error-analysis JSONL (worst-first sort is the
        # reader's one-liner: sort_values("cer"))
        from .evals import cer as _cer, wer as _wer

        with open(args.per_utt, "w", encoding="utf-8") as f:
            for row, ref, hyp in zip(rows, refs, hyps):
                f.write(json.dumps({
                    "audio": row.audio, "dialect": row.dialect,
                    "ref": ref, "hyp": hyp,
                    "cer": round(_cer(ref, hyp), 4),
                    "wer": round(_wer(ref, hyp), 4),
                }, ensure_ascii=False) + "\n")
        result["per_utt"] = args.per_utt
    print(json.dumps(result, ensure_ascii=False))
    return 0


def cmd_featurize(args) -> int:
    import numpy as np

    from .api import featurize

    feats = featurize(args.audio)
    out = args.output or (args.audio + ".logmel.npy")
    np.save(out, np.asarray(feats))
    print(f"wrote {out} shape={tuple(np.asarray(feats).shape)}")
    return 0


def cmd_train_lm(args) -> int:
    """Train a char n-gram LM over manifest transcripts for shallow fusion
    (decode/lm.py). The tokenizer comes from --checkpoint (vocab consistency
    with the acoustic model) or is built from the manifests."""
    from .data.manifest import read_manifest
    from .data.tokenizer import CharTokenizer
    from .decode.lm import NGramCharLM

    texts = []
    for m in args.manifest:
        texts.extend(read_manifest(m).texts())
    if args.checkpoint:
        from .api import load

        tokenizer = load(checkpoint=args.checkpoint).tokenizer
    else:
        tokenizer = CharTokenizer.build(texts)
    lm = NGramCharLM.train_from_texts(texts, tokenizer, order=args.order)
    lm.save(args.output)
    print(json.dumps({
        "lm": args.output, "order": args.order, "vocab": lm.vocab_size,
        "ngrams": len(lm.counts), "texts": len(texts),
    }))
    return 0


def cmd_train_unigram(args) -> int:
    """EM-train an SP-unigram subword vocab over manifest transcripts
    (SURVEY N9, reference requirements.txt:64). Point
    data.unigram_vocab at the output to train with it."""
    from .data.manifest import read_manifest
    from .data.unigram import UnigramTokenizer

    texts = []
    for m in args.manifest:
        texts.extend(read_manifest(m).texts())
    tok = UnigramTokenizer.train(
        texts, vocab_size=args.vocab_size, max_piece_len=args.max_piece_len
    )
    tok.save(args.output)
    if args.sp_vocab:
        tok.save_sp_vocab(args.sp_vocab)
    print(json.dumps({
        "unigram_vocab": args.output, "vocab": len(tok), "texts": len(texts),
        "multi_char_pieces": sum(1 for p in tok.vocab[2:] if len(p) > 1),
    }))
    return 0


def cmd_prepare(args) -> int:
    """Corpus prep (SURVEY 3.5): transcript table -> filtered, split
    manifests; optionally compute global-CMVN stats over the train split."""
    from .data.prepare import prepare_corpus

    paths = prepare_corpus(
        args.table,
        args.out_dir,
        audio_root=args.audio_root,
        dialect=args.dialect,
        min_seconds=args.min_seconds,
        max_seconds=args.max_seconds,
        dev_fraction=args.dev_fraction,
        test_fraction=args.test_fraction,
        seed=args.seed,
    )
    result = dict(paths)
    if args.cmvn:
        from .data.manifest import read_manifest
        from .data.tokenizer import CharTokenizer
        from .frontend.cmvn import compute_corpus_cmvn
        from .utils.config import DataConfig, FrontendConfig

        manifest = read_manifest(paths["train"])
        tok = CharTokenizer.build(manifest.texts())
        fe = FrontendConfig(num_mels=args.num_mels)
        acc = compute_corpus_cmvn(
            manifest, tok, DataConfig(batch_size=8, min_audio_seconds=args.min_seconds),
            fe,
        )
        stats_path = str(Path(args.out_dir) / f"{args.dialect or 'corpus'}_cmvn.npz")
        acc.save(stats_path)
        result["cmvn_stats"] = stats_path
    print(json.dumps(result, ensure_ascii=False))
    return 0


def cmd_import_whisper(args) -> int:
    from .models.whisper_import import import_hf_checkpoint

    bundle = import_hf_checkpoint(args.src, args.out)
    w = bundle.config.whisper
    print(json.dumps({
        "out": args.out, "name": w.name, "d_model": w.d_model,
        "layers": [w.encoder_layers, w.decoder_layers],
        "num_mels": w.num_mels, "vocab_size": w.vocab_size,
        "tokenizer": type(bundle.tokenizer).__name__ if bundle.tokenizer else None,
    }))
    return 0


def cmd_export_whisper(args) -> int:
    from .api import load
    from .models.whisper_import import export_hf_checkpoint

    bundle = load(checkpoint=args.checkpoint, config=args.config)
    if bundle.config.model_family != "whisper":
        print("export-whisper needs a whisper-family bundle", file=sys.stderr)
        return 1
    out = export_hf_checkpoint(bundle, args.out)
    print(json.dumps({"out": str(out)}))
    return 0


def cmd_serve(args) -> int:
    """Continuous-batching transcription service (serve/engine.py): audio
    paths from argv and/or stdin (one per line, streaming), results as
    JSONL in COMPLETION order — short utterances return while long ones
    are still decoding, instead of waiting for a static batch."""
    from .api import load
    from .serve import ServingEngine

    bundle = load(checkpoint=args.checkpoint, config=args.config)
    if args.int8:
        try:
            bundle = bundle.quantize()
        except NotImplementedError as e:
            print(f"error: --int8: {e}", file=sys.stderr)
            return 2
    try:
        eng = ServingEngine(
            bundle, slots=args.slots,
            steps_per_dispatch=args.steps_per_dispatch,
            timestamps=getattr(args, "timestamps", False),
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    paths = {}

    def emit(reqs):
        from .utils.captions import group_words

        for r in reqs:
            rec = {
                "audio": paths[r.rid],
                "text": r.text,
                "latency_s": round(r.finished_at - r.submitted_at, 4),
            }
            if r.timed is not None:
                rec["tokens"] = r.timed
                rec["words"] = group_words(r.timed)
            print(json.dumps(rec, ensure_ascii=False), flush=True)

    def feed(path):
        rid = eng.submit(path)
        paths[rid] = path
        # lanes saturated: decode now rather than queueing unboundedly
        while eng.in_flight > eng.slots:
            emit(eng.step())

    for a in args.audio:
        feed(a)
    if args.stdin:
        for line in sys.stdin:
            line = line.strip()
            if line:
                feed(line)
    while eng.in_flight:
        emit(eng.step())
    s = eng.stats
    print(
        f"served {s.completed} utterances in {s.dispatches} dispatches "
        f"({s.decode_steps} decode steps); latency mean "
        f"{s.mean_latency_s:.3f}s p95 {s.p95_latency_s:.3f}s",
        file=sys.stderr,
    )
    return 0


def cmd_build_native(args) -> int:
    from .utils.native_ext import build_native

    ok = build_native(verbose=True)
    print("native build:", "ok" if ok else "FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jiao_liao_asr")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="(adapter) fine-tune / multi-dialect stages")
    pt.add_argument("--config", required=True)
    pt.add_argument("--resume", action="store_true")
    pt.add_argument("--profile", metavar="LOGDIR", help="write an xprof trace")
    pt.add_argument(
        "--multihost",
        action="store_true",
        help="initialize jax.distributed before training (multi-process "
        "SPMD; set JL_COORDINATOR / "
        "JL_NUM_PROCESSES / JL_PROCESS_ID)",
    )
    pt.add_argument("override", nargs="*", help="key.subkey=value overrides")
    pt.set_defaults(fn=cmd_train)

    pr = sub.add_parser("transcribe", help="audio file(s) -> text")
    pr.add_argument("audio", nargs="+")
    pr.add_argument("--checkpoint")
    pr.add_argument("--config")
    pr.add_argument("--profile", metavar="LOGDIR", help="write an xprof trace")
    pr.add_argument(
        "--strategy",
        choices=["greedy", "beam", "beam_device", "ctc_greedy", "spec_greedy"],
        help="decode strategy override (default: the bundle's config)",
    )
    pr.add_argument("--beam-size", type=int, default=None)
    pr.add_argument(
        "--int8", action="store_true",
        help="int8-quantize the decoder weights before serving (whisper)",
    )
    pr.add_argument(
        "--timestamps", action="store_true",
        help="emit per-token start/end seconds (ctc/joint: CTC frame "
        "alignment; whisper: cross-attention DTW)",
    )
    pr.add_argument(
        "--caption", choices=["srt", "vtt"],
        help="write a subtitle sidecar file next to each audio file "
        "(implies --timestamps)",
    )
    pr.add_argument(
        "--stream", action="store_true",
        help="simulate live streaming: sliding-window greedy CTC with "
        "partial results per hop (serve/streaming.py; ctc/joint families)",
    )
    pr.add_argument("--stream-window", type=float, default=10.0,
                    help="streaming window seconds (default 10)")
    pr.add_argument("--stream-hop", type=float, default=0.4,
                    help="streaming hop seconds (default 0.4)")
    pr.add_argument("--stream-lookahead", type=float, default=0.64,
                    help="right context before a frame commits (default 0.64)")
    pr.set_defaults(fn=cmd_transcribe)

    pe = sub.add_parser("evaluate", help="CER/WER on a manifest")
    pe.add_argument("--manifest", required=True)
    pe.add_argument("--checkpoint")
    pe.add_argument("--config")
    pe.add_argument("--batch-size", type=int, default=16)
    pe.add_argument(
        "--decode", default="greedy",
        choices=["greedy", "beam", "beam_device", "ctc_greedy"],
    )
    pe.add_argument("--beam-size", type=int, default=8)
    pe.add_argument("--lm-path", default="", help="n-gram LM .npz for shallow fusion")
    pe.add_argument("--lm-weight", type=float, default=None)
    pe.add_argument(
        "--int8", action="store_true",
        help="evaluate the int8-quantized serving tree (whisper): CER/WER "
        "cost of ModelBundle.quantize() vs the bf16 checkpoint",
    )
    pe.add_argument(
        "--per-utt", metavar="OUT.jsonl",
        help="also write one error-analysis row per utterance "
        "(audio, dialect, ref, hyp, cer, wer)",
    )
    pe.set_defaults(fn=cmd_evaluate)

    pl = sub.add_parser("train-lm", help="char n-gram LM over manifests (fusion)")
    pl.add_argument("manifest", nargs="+")
    pl.add_argument("--output", required=True)
    pl.add_argument("--order", type=int, default=3)
    pl.add_argument("--checkpoint", help="take the tokenizer from this bundle")
    pl.set_defaults(fn=cmd_train_lm)

    pu = sub.add_parser(
        "train-unigram", help="EM-train an SP-unigram subword vocab (N9)"
    )
    pu.add_argument("manifest", nargs="+")
    pu.add_argument("--output", required=True)
    pu.add_argument("--vocab-size", type=int, default=1024)
    pu.add_argument("--max-piece-len", type=int, default=4)
    pu.add_argument("--sp-vocab", help="also dump spm_export_vocab TSV here")
    pu.set_defaults(fn=cmd_train_unigram)

    pi = sub.add_parser(
        "import-whisper",
        help="HF Whisper checkpoint dir (safetensors) -> bundle checkpoint",
    )
    pi.add_argument("src", help="HF dir: model.safetensors + config.json [+ tokenizer]")
    pi.add_argument("--out", required=True, help="bundle checkpoint dir to write")
    pi.set_defaults(fn=cmd_import_whisper)

    px = sub.add_parser(
        "export-whisper",
        help="whisper bundle checkpoint -> HF dir (from_pretrained-able)",
    )
    px.add_argument("--checkpoint", required=True)
    px.add_argument("--config")
    px.add_argument("--out", required=True, help="HF checkpoint dir to write")
    px.set_defaults(fn=cmd_export_whisper)

    pf = sub.add_parser("featurize", help="audio -> log-mel .npy")
    pf.add_argument("audio")
    pf.add_argument("--output")
    pf.set_defaults(fn=cmd_featurize)

    pp = sub.add_parser("prepare", help="transcript table -> train/dev/test manifests")
    pp.add_argument("table", help="TSV/CSV of (audio_path, transcript) rows")
    pp.add_argument("--out-dir", required=True)
    pp.add_argument("--audio-root", default="")
    pp.add_argument("--dialect", default="")
    pp.add_argument("--min-seconds", type=float, default=0.3)
    pp.add_argument("--max-seconds", type=float, default=30.0)
    pp.add_argument("--dev-fraction", type=float, default=0.05)
    pp.add_argument("--test-fraction", type=float, default=0.05)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--cmvn", action="store_true",
                    help="also compute global-CMVN stats over the train split")
    pp.add_argument("--num-mels", type=int, default=80)
    pp.set_defaults(fn=cmd_prepare)

    ps = sub.add_parser(
        "serve",
        help="continuous-batching transcription service (whisper family): "
        "audio paths from argv/stdin -> JSONL results in completion order",
    )
    ps.add_argument("audio", nargs="*", help="audio paths to serve immediately")
    ps.add_argument("--checkpoint")
    ps.add_argument("--config")
    ps.add_argument(
        "--stdin", action="store_true",
        help="also read audio paths from stdin, one per line (streaming)",
    )
    ps.add_argument("--slots", type=int, default=8, help="decode lanes")
    ps.add_argument(
        "--steps-per-dispatch", type=int, default=32,
        help="decode tokens per device dispatch (amortizes dispatch latency)",
    )
    ps.add_argument(
        "--int8", action="store_true",
        help="int8-quantize the decoder weights before serving",
    )
    ps.add_argument(
        "--timestamps", action="store_true",
        help="include per-token and word spans in each result "
        "(harvest-time cross-attention alignment)",
    )
    ps.set_defaults(fn=cmd_serve)

    pn = sub.add_parser("build-native", help="compile C++ host components")
    pn.set_defaults(fn=cmd_build_native)

    args = p.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
