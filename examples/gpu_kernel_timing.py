"""Time the plain XLA/cuDNN paths against library Pallas kernels on a GPU.

For each operation that once had a hand-written kernel here, time what the
program runs now (XLA, or cuDNN through jax.nn.dot_product_attention)
against the candidate kernel that ships with JAX under
jax/experimental/pallas/ops/gpu/ (the library's kernels, not this
repository's), in one process on one card:

- encoder attention at the flagship width (B=8, T=750, H=4, dh=128) and the
  large-v3 width (B=4, T=1500, H=20, dh=64), forward and forward+backward:
  cuDNN and XLA against the library Triton attention (`mha`, which needs T
  a multiple of its 128 block, so it runs at T padded to 768 / 1536 with
  the padding masked by segment ids);
- decode attention over a large-v3 cross cache (T_enc=1500, H=20, dh=64)
  at B=8 and 32: the plain head-major einsum against the library Triton
  `gqa` decode kernel (T padded to 1536 and split 12 ways, since the Triton
  route needs power-of-two blocks; masked by lengths);
- the int8 decoder GEMV (x [8, 1280] @ int8 [1280, 5120]): whether XLA's
  optimized HLO materializes a bf16 copy of the weight;
- large-v3 greedy decode tokens/s with bf16 weights against int8 weights.

Each timing is the mean over a jitted fori_loop of N dependent iterations,
after a warm-up call. Prints one JSON object per measurement; with
--out-dir, also writes them all to kernel_timing.json there, beside the
int8 GEMV's optimized HLO.

Usage: python examples/gpu_kernel_timing.py [--decode-layers 32]
           [--ops attention,decode_attention,int8_gemv,decode] [--out-dir DIR]
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = []


def emit(**rec):
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def loop_time(fn, args, iters: int = 50):
    """Seconds per iteration of fn(*args) chained `iters` times in one jit
    (each iteration's first input depends on the previous output)."""
    import jax
    import jax.numpy as jnp

    def body(i, carry):
        first, rest = carry[0], carry[1:]
        out = fn(first, *rest)
        leaf = jax.tree_util.tree_leaves(out)[0]
        bump = (jnp.sum(leaf.astype(jnp.float32)) * 1e-9).astype(first.dtype)
        return (first + bump,) + tuple(rest)

    run = jax.jit(lambda *a: jax.lax.fori_loop(0, iters, body, tuple(a))[0])
    jax.block_until_ready(run(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(run(*args))
    return (time.perf_counter() - t0) / iters


def time_attention(shape, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.pallas.ops.gpu import attention as lib_attention

    B, T, H, dh = shape
    rng = np.random.RandomState(seed)
    q, k, v = (jnp.asarray(rng.randn(B, T, H, dh), jnp.bfloat16) for _ in range(3))
    lens = jnp.full((B,), T, jnp.int32)
    scale = 1.0 / np.sqrt(dh)
    Tp = -(-T // 128) * 128
    pad = ((0, 0), (0, Tp - T), (0, 0), (0, 0))
    qp, kp, vp = (jnp.pad(a, pad) for a in (q, k, v))
    seg = jnp.broadcast_to((jnp.arange(Tp) < T).astype(jnp.int32), (B, Tp))

    def plain(impl):
        def f(q, k, v):
            return jax.nn.dot_product_attention(
                q, k, v, key_value_seq_lengths=lens, implementation=impl
            )
        return f

    def triton(q, k, v):
        return lib_attention.mha(q, k, v, seg, sm_scale=scale)

    def fwd_bwd(f):
        def g(q, k, v):
            return jax.grad(lambda a, b, c: jnp.sum(f(a, b, c).astype(jnp.float32)),
                            argnums=(0, 1, 2))(q, k, v)
        return g

    for name, f, args in (
        ("cudnn", plain("cudnn"), (q, k, v)),
        ("xla", plain("xla"), (q, k, v)),
        ("triton_library_mha", triton, (qp, kp, vp)),
    ):
        for mode, g in (("fwd", f), ("fwd_bwd", fwd_bwd(f))):
            try:
                ms = loop_time(g, args, iters=20) * 1e3
                emit(op="encoder_attention", shape=list(shape), impl=name,
                     mode=mode, ms=round(ms, 4),
                     padded_T=Tp if name.startswith("triton") else T)
            except Exception as e:  # a candidate that does not compile is a result
                emit(op="encoder_attention", shape=list(shape), impl=name,
                     mode=mode, error=f"{type(e).__name__}: {str(e)[:300]}")


def time_decode_attention(B: int, T: int = 1500, H: int = 20, dh: int = 64) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.pallas.ops.gpu import decode_attention as lib_decode

    rng = np.random.RandomState(B)
    q = jnp.asarray(rng.randn(B, H, 1, dh), jnp.bfloat16)
    k = jnp.asarray(rng.randn(B, H, T, dh), jnp.bfloat16)
    v = jnp.asarray(rng.randn(B, H, T, dh), jnp.bfloat16)
    lens = jnp.full((B,), T, jnp.int32)

    def plain(q, k, v):  # the head-major cache path of models/layers.py
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
        s = s / np.sqrt(dh)
        s = jnp.where(jnp.arange(T)[None, None, None, :] < lens[:, None, None, None],
                      s, jnp.finfo(jnp.float32).min)
        p = jax.nn.softmax(s, axis=-1).astype(q.dtype)
        return jnp.einsum("bhqk,bhkd->bhqd", p, v, preferred_element_type=jnp.float32)

    Tp, k_splits = -(-T // 128) * 128, 12  # 1536 = 12 splits of 128 keys
    kt = jnp.pad(k.transpose(0, 2, 1, 3), ((0, 0), (0, Tp - T), (0, 0), (0, 0)))
    vt = jnp.pad(v.transpose(0, 2, 1, 3), ((0, 0), (0, Tp - T), (0, 0), (0, 0)))

    def triton(q, k, v):
        return lib_decode.gqa(q[:, :, 0, :], k, v, kv_seq_len=lens,
                              k_splits=k_splits)

    bytes_read = 2 * B * H * T * dh * 2
    for name, f, args in (
        ("xla_plain", plain, (q, k, v)),
        ("triton_library_gqa", triton, (q, kt, vt)),
    ):
        try:
            s = loop_time(f, args, iters=100)
            emit(op="decode_attention", B=B, T_enc=T, H=H, dh=dh, impl=name,
                 us=round(s * 1e6, 3), gb_per_s=round(bytes_read / s / 1e9, 1),
                 padded_T=Tp if name.startswith("triton") else T)
        except Exception as e:
            emit(op="decode_attention", B=B, impl=name,
                 error=f"{type(e).__name__}: {str(e)[:300]}")


def check_int8_hlo(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jiao_liao_asr.ops.quant import int8_matmul, quantize_int8

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(8, 1280), jnp.bfloat16)
    q, s = quantize_int8(jnp.asarray(rng.randn(1280, 5120).astype(np.float32) * 0.02))
    hlo = jax.jit(int8_matmul).lower(x, q, s).compile().as_text()
    if out_dir:
        with open(os.path.join(out_dir, "int8_matmul_hlo.txt"), "w") as fh:
            fh.write(hlo)
    # a bf16 copy of the weight is materialized iff some instruction of the
    # entry computation produces a bf16 array of the weight's shape (the
    # GEMM then reads it from device memory instead of reading int8)
    entry = hlo[hlo.index("ENTRY"):]
    entry = entry[: entry.find("\n}\n") + 1 or len(entry)]
    materialized = any(
        f"= bf16[{shape}]" in line.replace("{", " ").split("(")[0] + " "
        or f"= bf16[{shape}]" in line
        for line in entry.splitlines()
        for shape in ("1280,5120", "5120,1280")
    )
    gemm_ops = sorted({
        tok for line in hlo.splitlines()
        for tok in ("__cublas$gemm", "__cublas$lt$matmul", "gemm_fusion", "__triton_gemm")
        if tok in line
    })
    us = loop_time(lambda x, q, s: int8_matmul(x, q, s), (x, q, s), iters=200) * 1e6
    emit(op="int8_gemv", shape=[8, 1280, 5120], us=round(us, 3),
         bf16_weight_materialized=materialized, gemm_kinds=gemm_ops)
    xb = jnp.asarray(np.asarray(q, np.float32) * np.asarray(s)[None, :], jnp.bfloat16)
    us_b = loop_time(lambda x, w: jnp.dot(x, w), (x, xb), iters=200) * 1e6
    emit(op="bf16_gemv", shape=[8, 1280, 5120], us=round(us_b, 3))


def time_decode(layers: int) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.decode.whisper_generate import (
        greedy_from_enc, resolve_specials,
    )
    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.models.whisper import WhisperModel
    from jiao_liao_asr.utils.config import (
        ExperimentConfig, FrontendConfig, whisper_preset,
    )

    w = dataclasses.replace(
        whisper_preset("large-v3"), encoder_layers=layers, decoder_layers=layers
    )
    cfg = ExperimentConfig(model_family="whisper", whisper=w,
                           frontend=FrontendConfig(num_mels=128))
    params = ModelBundle._init_params(cfg)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    bundle = ModelBundle(config=cfg, params=params, tokenizer=CharTokenizer([]))
    qparams = bundle.quantize().params
    model = WhisperModel(w)
    prompt, eot = resolve_specials(w)
    B, new = 8, 64
    wav = jnp.asarray(np.random.RandomState(1).randn(B, 480000).astype(np.float32) * 0.1)
    mel = featurize_batch(wav, cfg.frontend)
    enc = jax.jit(lambda p, m: model.apply({"params": p}, m, method="encode"))(params, mel)

    @jax.jit
    def decode(p, enc):
        return greedy_from_enc(model, p, enc, max_len=len(prompt) + new,
                               prompt=prompt, eot_id=-1)

    for name, p in (("bf16", params), ("int8", qparams), ("bf16", params), ("int8", qparams)):
        ids, n = decode(p, enc)
        jax.block_until_ready(ids)
        t0 = time.perf_counter()
        ids, n = decode(p, enc)
        jax.block_until_ready(ids)
        dt = time.perf_counter() - t0
        emit(op="large_v3_greedy_decode", layers=layers, B=B, weights=name,
             new_tokens=new, tok_s=round(B * new / dt, 1), s=round(dt, 4))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--decode-layers", type=int, default=32)
    ap.add_argument("--ops", default="attention,decode_attention,int8_gemv,decode",
                    help="comma-separated measurements to run")
    ap.add_argument("--out-dir", default="", help="directory for the JSON and HLO")
    args = ap.parse_args()
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default backend is {jax.default_backend()}")
    from jiao_liao_asr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    emit(op="card", nvidia_smi=card, device_kind=jax.devices()[0].device_kind,
         jax=jax.__version__)
    ops = set(args.ops.split(","))
    if "attention" in ops:
        time_attention((8, 750, 4, 128))
        time_attention((4, 1500, 20, 64))
    if "decode_attention" in ops:
        time_decode_attention(8)
        time_decode_attention(32)
    if "int8_gemv" in ops:
        check_int8_hlo(args.out_dir)
    if "decode" in ops:
        time_decode(args.decode_layers)
    if args.out_dir:
        with open(os.path.join(args.out_dir, "kernel_timing.json"), "w") as fh:
            json.dump(RESULTS, fh, indent=1)


if __name__ == "__main__":
    main()
