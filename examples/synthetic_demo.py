"""End-to-end demo on synthetic data: corpus prep -> adapter fine-tune ->
evaluation, exercising the full BASELINE configs[2]/[3] stack.

Synthesizes a toy "dialect": each character of a small vocab maps to a
distinct tone (sine) sequence, so a model must genuinely learn
frame-to-symbol alignment. Stage 1 trains on the "neighbor" dialect (tones
400..1200 Hz); stage 2 adapts to the low-resource "target" dialect whose
tones are shifted (multi-dialect knowledge transfer, SURVEY 3.4). Prints
corpus CER before/after each stage.

Run: python examples/synthetic_demo.py [--steps 300] [--outdir /tmp/jl_demo]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root


VOCAB = list("胶辽官话语音识别你好世界")


def synth_wave(text: str, base_hz: float, sr: int = 16000, per_char: float = 0.25,
               seed: int = 0) -> np.ndarray:
    """Each char -> a tone at base_hz * (1 + idx/len(vOCAB)), 250 ms."""
    rng = np.random.RandomState(seed)
    pieces = []
    for ch in text:
        idx = VOCAB.index(ch)
        f = base_hz * (1.0 + idx / len(VOCAB))
        t = np.arange(int(sr * per_char)) / sr
        tone = 0.3 * np.sin(2 * np.pi * f * t) * np.hanning(len(t))
        pieces.append(tone)
    wav = np.concatenate(pieces) + 0.01 * rng.randn(sum(len(p) for p in pieces))
    return wav.astype(np.float32)


def make_corpus(outdir: Path, name: str, base_hz: float, n: int, seed: int):
    from jiao_liao_asr.data import ManifestRow, write_manifest
    from jiao_liao_asr.frontend.audio_io import write_wav

    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        text = "".join(rng.choice(VOCAB, rng.randint(2, 7)))
        wav = synth_wave(text, base_hz, seed=seed * 1000 + i)
        p = outdir / f"{name}_{i}.wav"
        write_wav(p, wav, 16000)
        rows.append(ManifestRow(str(p), text, len(wav) / 16000.0, name))
    mp = outdir / f"{name}.jsonl"
    write_manifest(rows, mp)
    return str(mp)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--outdir", default="/tmp/jl_demo")
    ap.add_argument("--target-steps", type=int, default=150)
    ap.add_argument(
        "--compare-adapters", action="store_true",
        help="run stage 2 once per adapter kind (wf/att/bottleneck) from the "
             "same stage-1 params — the paper's comparison (README.md:1)",
    )
    ap.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (e.g. while another process holds "
             "the card)",
    )
    ap.add_argument(
        "--assert-ordering", action="store_true",
        help="with --compare-adapters: exit 1 unless the protocol's robust "
             "invariants hold on this seeded run — every adapted kind "
             "improves CER over the zero-shot transfer baseline AND every "
             "kind reaches CER <= 0.5 (large margin under the ~0.93 "
             "zero-shot). The paper's exact wf/att-vs-bottleneck ordering "
             "(README.md:1) is NOT asserted: the synthetic tone-shift task "
             "is too easy to discriminate adapter families — the "
             "per-family CERs are recorded as tracked data instead",
    )
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from jiao_liao_asr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)

    from jiao_liao_asr.data.manifest import read_manifest
    from jiao_liao_asr.train.engine import evaluate_manifest
    from jiao_liao_asr.train.schedules import run_stages
    from jiao_liao_asr.utils.config import (
        AdapterConfig,
        CTCModelConfig,
        DataConfig,
        DialectStage,
        ExperimentConfig,
        FrontendConfig,
        OptimizerConfig,
        SpecAugmentConfig,
    )

    # neighboring dialect: plenty of data; target: same symbol->tone system
    # shifted ~9% (a "neighboring dialect" per the paper's premise), scarce
    neighbor = make_corpus(out, "neighbor", 440.0, 64, seed=1)
    target = make_corpus(out, "jiaoliao", 480.0, 24, seed=2)  # low-resource
    target_test = make_corpus(out, "jiaoliao_test", 480.0, 16, seed=3)

    cfg = ExperimentConfig(
        model_family="ctc",
        frontend=FrontendConfig(chunk_seconds=2.0),
        ctc_model=CTCModelConfig(
            vocab_size=16, d_model=128, num_layers=4, num_heads=4, mlp_dim=512,
            conv_channels=128, dropout=0.1,
            adapter=AdapterConfig(kind="wf", wf_rank=8, dropout=0.0),
        ),
        specaugment=SpecAugmentConfig(enabled=True, freq_mask_width=10),
        data=DataConfig(
            batch_size=16, bucket_boundaries_seconds=(2.0,), max_text_len=8,
            min_audio_seconds=0.1,
        ),
    )
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=2e-3, warmup_steps=30, total_steps=args.steps,
        schedule="cosine",
    )
    stage1 = DialectStage(name="neighbor", manifests=(neighbor,), steps=args.steps,
                          train_adapters_only=False)
    stage2 = DialectStage(name="jiaoliao", manifests=(target,),
                          steps=args.target_steps,
                          train_adapters_only=True)  # frozen backbone + WFAdapter

    test_m = read_manifest(target_test)

    # stage 1 only: zero-shot transfer baseline on the target dialect
    cfg1 = dataclasses.replace(cfg, stages=(stage1,))
    params1, tokenizer, hist1 = run_stages(cfg1)
    print(json.dumps({"stage1": hist1}, ensure_ascii=False))
    zero_shot = evaluate_manifest(cfg1, params1, tokenizer, test_m)
    print(json.dumps({"after_neighbor_only": zero_shot}, ensure_ascii=False))

    # stage 2: adapter-only adaptation on the low-resource target.
    # snapshot stage-1 params to host first: the jitted train step donates
    # its input buffers, so device arrays grafted into one stage-2 run would
    # be deleted before the next adapter kind's run
    import jax as _jax

    params1 = _jax.tree_util.tree_map(np.asarray, params1)
    kinds = ["wf", "att", "bottleneck"] if args.compare_adapters else ["wf"]
    adapted_by_kind = {}
    for kind in kinds:
        cfg2 = dataclasses.replace(
            cfg,
            ctc_model=dataclasses.replace(
                cfg.ctc_model,
                adapter=dataclasses.replace(cfg.ctc_model.adapter, kind=kind),
            ),
            stages=(stage2,),
        )
        # Stage-1 params carry the stage-1 adapter modules in the tree; for a
        # fair comparison re-init with THIS adapter kind and graft the shared
        # backbone leaves over (fresh adapters keep their identity init).
        import jax

        from jiao_liao_asr.models.bundle import ModelBundle

        from jiao_liao_asr.models.adapters import param_is_adapter

        fresh = ModelBundle._init_params(cfg2)
        p1_map = {
            jax.tree_util.keystr(kp): v
            for kp, v in jax.tree_util.tree_leaves_with_path(params1)
        }

        def _graft(kp, leaf):
            keys = tuple(str(getattr(k, "key", k)) for k in kp)
            if param_is_adapter(keys):
                return leaf  # every kind starts from its identity init
            return p1_map.get(jax.tree_util.keystr(kp), leaf)

        merged = jax.tree_util.tree_map_with_path(_graft, fresh)
        params2, tokenizer, hist2 = run_stages(cfg2, params=merged, tokenizer=tokenizer)
        adapted = evaluate_manifest(cfg2, params2, tokenizer, test_m)
        adapted_by_kind[kind] = adapted
        print(json.dumps({f"after_adaptation_{kind}": adapted}, ensure_ascii=False))

    # quality-protocol ordering (the one claim the reference publishes,
    # README.md:1): summary line + optional hard assertion so the claim
    # direction has a standing regression check. Fully seeded above ->
    # deterministic for a given code version.
    if args.compare_adapters:
        zs = zero_shot["eval_cer"]
        cers = {k: v["eval_cer"] for k, v in adapted_by_kind.items()}
        transfer_helps = all(c < zs for c in cers.values())
        all_adapt = max(cers.values()) <= 0.5
        # informational, NOT load-bearing for ok: the toy task can't
        # discriminate adapter families (bottleneck occasionally beats wf)
        novel_not_worse = min(cers["wf"], cers["att"]) <= cers["bottleneck"]
        summary = {
            "quality_ordering": {
                "zero_shot_cer": zs,
                **{f"cer_{k}": c for k, c in cers.items()},
                "transfer_helps": transfer_helps,
                "all_kinds_adapt": all_adapt,
                "novel_not_worse_than_bottleneck": novel_not_worse,
                "ok": transfer_helps and all_adapt,
            }
        }
        print(json.dumps(summary, ensure_ascii=False))
        if args.assert_ordering and not summary["quality_ordering"]["ok"]:
            sys.exit(1)


if __name__ == "__main__":
    main()
