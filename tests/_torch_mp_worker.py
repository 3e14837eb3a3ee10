"""One rank of tests/test_torch_multiprocess.py's gather check, run under
`_torch_dist.run_ranks`:

    python tests/_torch_mp_worker.py OUT_PREFIX

Each rank holds predictions of other keys and counts (JAX's
tests/test_multiprocess.py's), merges them with
`Evaluator.gather_predictions`, and checks the runtime's mesh refusals
against the two-rank world; it writes ``OUT_PREFIX.rank{r}.json``.
Imports no JAX.
"""

import json
import sys

import torch.distributed as dist

from mm_interleaved_tpu_torch.engine.evaluator import Evaluator
from mm_interleaved_tpu_torch.parallel.inference import (check_runtime,
                                                         runtime_mesh_shape)


def main(prefix: str) -> None:
    dist.init_process_group("gloo")
    r = dist.get_rank()
    local = {0: "a cat", 2: "a dog"} if r == 0 else {1: "a bird"}
    merged = Evaluator.gather_predictions(local)
    out = {"merged": {str(k): v for k, v in sorted(merged.items())},
           "keys_are_ints": all(isinstance(k, int) for k in merged)}
    refused = {}
    for name, mesh in (("tensor_4", {"tensor": 4}),
                       ("data_2_fsdp_2", {"data": 2, "fsdp": 2})):
        try:
            check_runtime(mesh)
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    out["refused"] = refused
    out["accepted"] = {name: list(runtime_mesh_shape(mesh)) for name, mesh in
                       (("tensor_2", {"tensor": 2}),
                        ("fsdp_2", {"fsdp": 2}),
                        ("data_rest", {"data": -1}))}
    with open(f"{prefix}.rank{r}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
