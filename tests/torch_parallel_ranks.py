"""The ranks of tests/test_torch_parallel.py: one process group of four
gloo ranks on the CPU, started once for every case of that file.

    python tests/torch_parallel_ranks.py <cases.pt> <results.pt>

<cases.pt> (written by the test) holds the whole models and the batches.
Each rank runs every case on its mesh: a train step and an eval step on a
2 x 2 (data x model) mesh, with and without SpecAugment, and the decodes
on a 4 x 1 mesh; rank 0 keeps those results. Each rank also runs a
quarter of the cases in one process (no mesh). Rank r writes what it
kept to <results.pt>.<r>. Imports torch and the port only, so the ranks
start without JAX.
"""

import copy
import sys

import torch

N_RANKS = 4


def _train_case(case, mesh):
    """One TrainStep and one EvalStep -> (metrics, full gradients by
    name, eval losses)."""
    from tpu_asr_torch.train import EvalStep, NoamAdam, TrainStep
    model = copy.deepcopy(case["model"])
    opt = NoamAdam(model.parameters(), case["d_model"], 100, 1.0, 5.0)
    step = TrainStep(model, opt, specaug=case.get("specaug"), device="cpu",
                     seed=3, mesh=mesh)
    grads = {}
    update = opt.update

    def capture(g, norm=None):
        grads["list"] = [t.clone() for t in g]
        return update(g, norm)
    opt.update = capture
    metrics = {k: float(v) for k, v in step(case["batch"]).items()}
    names = {id(p): n for n, p in model.named_parameters()}
    by_name = {names[id(p)]: g for p, g in zip(opt.params, grads["list"])}
    if mesh is not None and mesh.n_model > 1:
        by_name = {n: g if step.specs[n] is None else
                   mesh.model.all_gather(g, step.specs[n])
                   for n, g in by_name.items()}
    # the eval step on the weights before the update
    model = copy.deepcopy(case["model"])
    if mesh is not None:
        from tpu_asr_torch.parallel import shard_params
        shard_params(model, mesh)
    evals = {k: float(v) for k, v in
             EvalStep(model, device="cpu", mesh=mesh)(case["batch"]).items()}
    return metrics, by_name, evals


def _decode_case(case, mesh):
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    rec = Recognizer(case["cfg"], copy.deepcopy(case["model"]),
                     mode=case["mode"], beam=BeamConfig(**case["beam"]),
                     device="cpu", mesh=mesh)
    return rec.decode_batch_nbest(case["batch"])


def run(cases_path: str, out_path: str) -> None:
    """Every case on its mesh (rank 0 keeps the result), and each rank
    a share of the cases in one process; writes <out_path>.<rank>."""
    torch.set_num_threads(1)
    from tpu_asr_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed("cpu")
    meshes = {"2x2": make_mesh(2, 2), "4x1": make_mesh(4, 1)}
    rank = meshes["2x2"].rank
    cases = torch.load(cases_path, weights_only=False)
    results = {}
    for i, (name, case) in enumerate(cases.items()):
        mesh = meshes[case["mesh"]]
        run_case = _decode_case if case["kind"] == "decode" else _train_case
        got = run_case(case, mesh)
        if rank == 0:
            results.setdefault(name, {})["mesh"] = got
        if i % N_RANKS == rank:
            results.setdefault(name, {})["single"] = run_case(case, None)
    torch.save(results, f"{out_path}.{rank}")


if __name__ == "__main__":
    from tpu_asr_torch.parallel.mesh import spawn_ranks
    spawn_ranks("torch_parallel_ranks:run", N_RANKS, sys.argv[1],
                sys.argv[2])
