"""Pin the JAX FSM decoder's answers for the port's chip check.

Writes ``libdeflate_tpu_torch/experiments/fsm_pins.json``: for each case
of the damaged, incomplete, trap and edge sets of
``libdeflate_tpu_torch/experiments/fsm_cases.py``, the 4-tuple of
``libdeflate_tpu.decompress.tpu.decompress_chunks`` at the sets' batch
shape (B = 8, N = 8192, out_cap 16384): the SHA-256 of the whole output
row, out_len, consumed and the result.  ``chip_smoke.py`` holds the
card's FSM kernel to these, where there is no JAX, and
``tests/test_torch_fsm.py`` keeps the file equal to what the JAX package
and the port's plain version give.

    JAX_PLATFORMS=cpu python tests/pin_fsm.py

With ``--pallas`` it writes nothing and prints, for each pinned set, how
many 4-tuples of the JAX package's two decoders differ on the CPU: the FSM
decoder against the unknown-size Pallas decoder
(``pallas_decode.decompress_chunks``, interpret mode), which the mesh's
"auto" takes on a TPU.  The Pallas decoder leaves stale ring words past a
row's out_len where the FSM decoder leaves zeros; those bytes are zeroed
before the rows are compared.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from libdeflate_tpu.decompress import tpu as dtpu  # noqa: E402
from libdeflate_tpu_torch.experiments import crafted_streams as cs  # noqa: E402
from libdeflate_tpu_torch.experiments import fsm_cases as fc  # noqa: E402

PINS = ROOT / "libdeflate_tpu_torch" / "experiments" / "fsm_pins.json"


def jax_rows(cases) -> list:
    """[case name, SHA-256, out_len, consumed, result] of each case."""
    rows = []
    for bufs, lens, n in fc.batches(cases):
        res = dtpu.decompress_chunks(jnp.asarray(bufs), jnp.asarray(lens),
                                     fc.OUT)
        rows += fc.pin_rows(*res, n)
    return [[name] + row for (name, _, _), row in zip(cases, rows)]


def pins() -> dict:
    sets = fc.sets(cs.repo_text())
    return {"shape": [fc.B, fc.N, fc.OUT],
            "sets": {name: jax_rows(sets[name]) for name in fc.PINNED_SETS}}


def pallas_differences() -> None:
    from libdeflate_tpu.decompress import pallas_decode as pd

    sets = fc.sets(cs.repo_text())
    for name in fc.PINNED_SETS:
        rows = []
        for bufs, lens, n in fc.batches(sets[name]):
            out, ol, cons, res = (np.asarray(x) for x in pd.decompress_chunks(
                jnp.asarray(bufs), jnp.asarray(lens), fc.OUT, interpret=True))
            out = np.where(np.arange(fc.OUT) < ol[:, None], out, 0)
            rows += fc.pin_rows(out, ol, cons, res, n)
        fsm_rows = [r[1:] for r in jax_rows(sets[name])]
        fields = [sum(a[i] != b[i] for a, b in zip(rows, fsm_rows))
                  for i in range(4)]
        differ = sum(a != b for a, b in zip(rows, fsm_rows))
        print(f"{name}: {differ} of {len(rows)} 4-tuples differ (out rows "
              f"{fields[0]}, out_len {fields[1]}, consumed {fields[2]}, "
              f"result {fields[3]})")


def main() -> None:
    if sys.argv[1:] == ["--pallas"]:
        pallas_differences()
        return
    p = pins()
    sets = ",\n".join(
        f' "{name}": [\n' + ",\n".join(f"  {json.dumps(r)}" for r in rows)
        + "\n ]" for name, rows in p["sets"].items())
    PINS.write_text(f'{{"shape": {json.dumps(p["shape"])}, "sets": {{\n'
                    f"{sets}}}}}\n")
    print(f"wrote {PINS}")


if __name__ == "__main__":
    main()
