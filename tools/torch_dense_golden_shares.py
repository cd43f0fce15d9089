"""How far the port's world-4 dense step lands from the JAX golden, per
tensor, on the CPU.

  python3 tools/torch_dense_golden_shares.py

Run from the repository root. Four gloo ranks on the CPU replay
``tests/data/torch_dense_train_world4_golden.npz`` through
``make_train_step(mesh=)`` three times: its f32 run as the CPU computes
it, its f32 run with the interaction's operands and the dense classes'
cotangents rounded to bf16 as the card rounds them
(``mxu_operand_dtype`` returning bf16, the card's rule), and its bf16 run.
For each it prints one JSON line: every final tensor's error as a share
of that tensor's largest update over the three steps (what
``train_golden.UPDATE_TOL`` bounds), the worst share and the worst loss
error. The bf16 run carries the JAX step's bf16 sum of the replicated
gradients, which the port does in f32 (``train_golden``'s docstring).
"""

import json
import os
import socket
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RUNS = (("f32", False), ("f32", True), ("bf16", False))


def rank_main(rank: int, port: int, outdir: str) -> None:
  import numpy as np
  import torch

  from distributed_embeddings_torch import train_golden
  from distributed_embeddings_torch.models import dlrm
  from distributed_embeddings_torch.parallel import lookup_engine
  from distributed_embeddings_torch.parallel.mesh import create_mesh

  torch.set_num_threads(1)
  mesh = create_mesh(4, rank, f"tcp://127.0.0.1:{port}", device="cpu")
  golden = train_golden.load(train_golden.DENSE_WORLD4_PATH)
  rule = dlrm.mxu_operand_dtype
  out = []
  try:
    for compute, card in RUNS:
      as_card = (lambda dt, dev: torch.bfloat16) if card else rule
      dlrm.mxu_operand_dtype = lookup_engine.mxu_operand_dtype = as_card
      losses, got, _ = train_golden.replay_dense_world4(golden, mesh,
                                                        compute=compute)
      init = train_golden.dense_initial(golden)
      want = train_golden.dense_final(golden, compute)
      shares = {k: float(np.abs(got[k] - w).max() / np.abs(w - init[k]).max())
                for k, w in want.items()}
      out.append({"run": compute + (" with the card's bf16 operands"
                                    if card else ""),
                  "worst_share": max(shares.values()),
                  "loss_max_abs_err": float(np.abs(
                      np.asarray(losses) - golden[f"{compute}_losses"]).max()),
                  "shares": shares})
  finally:
    dlrm.mxu_operand_dtype = lookup_engine.mxu_operand_dtype = rule
    mesh.close()
  if rank == 0:
    with open(os.path.join(outdir, "shares.json"), "w") as f:
      json.dump(out, f)


def main() -> int:
  import tempfile

  import torch.multiprocessing as mp

  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
  outdir = tempfile.mkdtemp(prefix="torch_dense_golden_shares_")
  mp.spawn(rank_main, args=(port, outdir), nprocs=4, join=True)
  with open(os.path.join(outdir, "shares.json")) as f:
    for line in json.load(f):
      print(json.dumps(line))
  return 0


if __name__ == "__main__":
  sys.exit(main())
