"""The comparison that decides ``correct``: what the program produced at
the timed sizes against the plain float32 reference (``reference/``),
which takes from the program nothing but the readings it judges.  The
reference follows the set-up steps from the seed's weights; in a managed
cell one of them is the loop's Eq. 7 recovered step (``setup_fail_at``),
which the reference takes as the fault-free step it stands for.

Numbers compared, each with the cell's limit (``limits`` in the cell's
file; ``PERF.md`` gives the readings each was set from):

* ``loss_<t>``: the relative gap of set-up step t's loss (the recovered
  step reports none);
* ``grad_final_norm``: the first gradient as the optimizer got it (its
  first moment after one step) of the final norm's scale, element by
  element: the norm of the difference over the reference's norm (the leaf
  nearest the loss, where bfloat16's rounding is least amplified by
  depth; ``grad_diff``, the same over every leaf, and ``grad``, the gap of
  the norms by the worst leaf, are read but not compared);
* ``grad_mixer``: the gap of the norms of that first gradient, by the
  worst of the leaves that the mixers' backward kernels produce directly
  (the Mamba2 input projection, which takes the SSD scan's backward and
  the gated norm's, and attention's q, k and v projections), against the
  reference's norm of the leaf or of the median leaf, whichever is larger;
* ``change``: the parameters' change after the set-up steps (the master
  weights that the window starts from), by the worst leaf as ``grad``,
  leaving out leaves whose first reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone);
* managed cells: ``recovered_gnorm`` (the recovered step's global gradient
  norm, relative, against the reference's fault-free gradient at that
  step) and ``snapshot`` (leaves of the snapshot that the tier holds when
  the window closes whose exact checksum differs from the device state it
  was taken from, plus one if it holds none or one of another step:
  limit 0).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Sequence

import torch

from portbench import data, weights
from portbench.reference import adamw
from portbench.reference import model as ref_model

FINAL_NORM = "final_norm/scale"
MIXER_INPUTS = ("/mamba/w_in", "/attn/wq", "/attn/wk", "/attn/wv")


def worst_leaf(program: Dict[str, float], ref: Dict[str, float],
               keep: Optional[Sequence[str]] = None) -> float:
    med = statistics.median(ref.values())
    keys = [k for k in ref if keep is None or k in keep]
    if set(program) != set(ref):
        return math.inf
    return max(abs(program[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def moving(ref: dict) -> list:
    """Leaves whose first reference gradient is at least a thousandth of
    the median leaf's."""
    med = statistics.median(ref["grad1"].values())
    return [k for k, v in ref["grad1"].items() if v >= 1e-3 * med]


def mixer_inputs(ref: dict) -> list:
    return [k for k in ref["g1"] if k.endswith(MIXER_INPUTS)]


def microbatches(cell: dict, cfg: dict, seed: int, step: int, device,
                 which=None):
    t = cell["traffic"]
    mb = t["micro_batch"]
    return [data.batch(seed, step, i * mb, mb, t["seq_len"],
                       cfg["vocab"]).to(device)
            for i in (range(t["n_micro"]) if which is None else which)]


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tree)
    vals = torch.stack([tree[k].norm() for k in keys]).tolist()
    return dict(zip(keys, vals))


def stored(master: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor]):
    """The parameters as the configuration stores them: each float32
    master weight rounded to its leaf's dtype (bfloat16 for the matrices
    and norms), taken back to float32 for the arithmetic."""
    return {k: v.to(like[k].dtype).float() if like[k].dtype != v.dtype
            else v.clone() for k, v in master.items()}


def moment_gap(mine: Dict[str, torch.Tensor],
               against: Dict[str, torch.Tensor]) -> dict:
    """||mine - against|| / ||mine||, ``against`` taken leaf by leaf to
    ``mine``'s device: over every leaf together (``global``), by leaf
    (``leaf``) and, for a leaf of stacked layers, by layer (``layer``)."""
    num = den = 0.0
    leaf, layer = {}, {}
    for k, v in mine.items():
        diff = (v - against[k].to(v.device, torch.float32)).square()
        ref = v.square()
        n, d = float(diff.sum()), float(ref.sum())
        num, den = num + n, den + d
        leaf[k] = math.sqrt(n / d) if d else math.inf
        if v.dim() >= 2 and k.startswith("segments/"):
            dims = tuple(range(1, v.dim()))
            layer[k] = (diff.sum(dims) / ref.sum(dims).clamp(min=1e-30)) \
                .sqrt().tolist()
    return {"global": math.sqrt(num / den) if den else math.inf,
            "leaf": leaf, "layer": layer}


def run_reference(cell: dict, cfg: dict, seed: int, device,
                  prec=ref_model.F32, which=None, rec_which=None,
                  against=None, keep_mu1=False) -> dict:
    """The reference's readings over the set-up steps from the seed's
    weights (``which`` micro-batches of each step, default all; at the
    managed cell's recovered step ``rec_which``, if given, over the step's
    count).  At the recovered step it also reads the global norm of the
    gradient (``rec_gnorm``).  Training keeps float32 master weights and
    computes each step at the parameters as the configuration stores them
    (``stored``), the mixed-precision semantics that the configuration's
    dtype states; every operation is float32 (``prec``: the control's
    float8).  Given ``against`` (another run's first moments after step
    1, by path), ``g1_diff`` is their gap from this run's
    (``moment_gap``); ``keep_mu1`` keeps this run's on the host in
    bfloat16 for another run to be held against."""
    hp = cell["optimizer"]
    n = cell["traffic"]["n_micro"]
    rec_step = cell.get("managed", {}).get("setup_fail_at")
    init = weights.make(cfg, seed, device)
    master = {k: v.to(torch.float32, copy=True) for k, v in init.items()}
    mu, nu = adamw.init(master)
    out = {"losses": []}
    for t in range(1, cell["warmup_steps"] + 1):
        lost = t == rec_step and rec_which is not None
        loss, g = ref_model.grads(
            stored(master, init), microbatches(
                cell, cfg, seed, t, device, rec_which if lost else which),
            cfg, prec)
        if lost:
            g = {k: v * (len(rec_which) / n) for k, v in g.items()}
        if t == rec_step:
            out["rec_gnorm"] = math.sqrt(sum(
                v * v for v in norms(g).values()))
        adamw.step(master, g, mu, nu, t, hp)
        out["losses"].append(loss.item())
        if t == 1:
            out["grad1"] = norms(g)
            out["g1"] = {k: v / (1 - hp["b1"]) for k, v in norms(mu).items()}
            if against is not None:
                gaps = moment_gap(mu, against)
                out["g1_diff"] = gaps.pop("global")
                out["g1_gaps"] = gaps
            if keep_mu1:
                out["mu1"] = {k: v.to("cpu", torch.bfloat16)
                              for k, v in mu.items()}
        del g
    out["change"] = norms({k: master[k] - init[k].float() for k in master})
    del master, mu, nu, init
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def reference(cell: dict, cfg: dict, seed: int, device,
              program: dict) -> dict:
    with ref_model.float32_matmul():
        return run_reference(cell, cfg, seed, device,
                             against=program["mu1"])


def numbers(cell: dict, program: dict, ref: dict) -> Dict[str, float]:
    """Each compared number of ``program`` (the program's readings, or a
    control's put in its place) against ``ref``."""
    out = {f"loss_{t}": abs(p - r) / abs(r) for t, (p, r) in
           enumerate(zip(program["losses"], ref["losses"]), 1)
           if p is not None}
    out.update({
        "grad": worst_leaf(program["g1"], ref["g1"]),
        # the gaps are worked out where both moments are at hand: by the
        # reference for the program, by a control's own run for it
        "grad_diff": program.get("g1_diff", ref.get("g1_diff", math.inf)),
        "grad_final_norm": program.get("g1_gaps", ref.get(
            "g1_gaps", {"leaf": {}}))["leaf"].get(FINAL_NORM, math.inf),
        "grad_mixer": worst_leaf(program["g1"], ref["g1"],
                                 mixer_inputs(ref)),
        "change": worst_leaf(program["change"], ref["change"], moving(ref)),
    })
    if "managed" in cell:
        rec = program.get("recovered")
        out["recovered_gnorm"] = math.inf if rec is None \
            or "rec_gnorm" not in ref else \
            abs(rec["gnorm"] - ref["rec_gnorm"]) / ref["rec_gnorm"]
        if "snapshots" in program:
            snaps = program["snapshots"]
            out["snapshot"] = float(snaps["mismatched"]
                                    + (snaps["held"] == 0))
    return out


def compare(cell: dict, program: dict, ref: dict) -> Dict[str, dict]:
    """The numbers that the cell holds to a limit (one that is missing
    reads infinite); the others are read (``readings.py``) but not
    compared (``PERF.md`` says why)."""
    nums = numbers(cell, program, ref)
    return {k: {"value": nums.get(k, math.inf), "limit": limit}
            for k, limit in cell["limits"].items()}
