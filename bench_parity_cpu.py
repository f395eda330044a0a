"""CPU-JAX half of the greedy text-parity proof (bench.py::bench_parity).

Loads the overfit flagship params + synthetic utterances from an .npz, runs
the same model on XLA:CPU and prints the greedy texts as one JSON line.
bench.py diffs them against the texts decoded on the card — BASELINE's
"decode text parity (greedy), bit-for-bit at text level, accelerator &
CPU-JAX path". bench.py starts it with JAX_PLATFORMS=cpu.
"""

import json
import sys


def main() -> None:
    npz_path, vocab = sys.argv[1], int(sys.argv[2])
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from jiao_liao_asr.decode.ctc import ctc_greedy_decode
    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.models.ctc_model import CTCEncoderModel
    from jiao_liao_asr.utils.config import (
        CTCModelConfig,
        FrontendConfig,
    )

    data = np.load(npz_path)
    wavs = data["wavs"]
    lengths = data["lengths"]
    params: dict = {}
    for key in data.files:
        if not key.startswith("p_"):
            continue
        node = params
        parts = key[2:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(data[key])

    fe = FrontendConfig()
    model = CTCEncoderModel(CTCModelConfig(vocab_size=vocab))
    hop = fe.hop_length

    @jax.jit
    def infer(params, wav, lens):
        feats = featurize_batch(wav, fe)
        lp, out_lens = model.apply(
            {"params": params}, feats, lens // hop, deterministic=True
        )
        return ctc_greedy_decode(lp, out_lens)

    texts = []
    B = 16  # chunked: the CPU forward of 64 x 8 s at once is memory-hungry
    for i in range(0, len(wavs), B):
        ids, lens = infer(
            params, jnp.asarray(wavs[i : i + B]), jnp.asarray(lengths[i : i + B])
        )
        ids, lens = np.asarray(ids), np.asarray(lens)
        for row, n in zip(ids, lens):
            texts.append(" ".join(str(int(t)) for t in row[: int(n)]))
    print(json.dumps(texts))


if __name__ == "__main__":
    main()
