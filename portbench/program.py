"""The system under test, built from a configuration file: the program's
data source over the benchmark's films, its DSNT-AL task, and its
backbone (the configuration's `model_name`) with the benchmark's weights.

This is the one module of the harness that imports the program
(`contouring_uncertainty_torch`), and only inside its functions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench import films
from portbench import weights as weights_lib


def _group(node: films.Node):
    from contouring_uncertainty_torch.data.camus import Group

    return Group({k: _group(v) if isinstance(v, films.Node) else v
                  for k, v in node.members.items()}, dict(node.attrs))


def make_films(config: Dict, seed: int) -> films.Node:
    """The configuration's films from the seed: a CAMUS-layout tree."""
    d = config["data"]
    return films.make_camus_tree(d["n_patients"], 2 * d["points_per_side"] - 1, d["size"],
                                 seed, d["fold"])


def data_source(config: Dict, made: films.Node):
    """The program's data source over the films; it extracts the landmarks."""
    from contouring_uncertainty_torch.data.camus import CamusContourData

    d = config["data"]
    return CamusContourData.from_arrays(_group(made), fold=d["fold"],
                                        points_per_side=d["points_per_side"])


def task_and_model(config: Dict, data, seed: int, device, init: weights_lib.Init
                   ) -> Tuple[object, torch.nn.Module, Dict[str, torch.Tensor]]:
    """The program's DSNT-AL task, its backbone on `device` with the
    benchmark's weights from `seed` by the initialisation rule `init`, and
    those weights."""
    from contouring_uncertainty_torch.models import build_backbone
    from contouring_uncertainty_torch.tasks import DSNTAleatoric

    t = config["task"]
    task = DSNTAleatoric(data_params=data.data_params, covar=t["covar"],
                         mse_weight=t["mse_weight"], log_penalty_weight=t["log_penalty_weight"],
                         t_a=t["t_a"], t_e=t["t_e"], model_kwargs=dict(config["model"]),
                         model_name=config["model_name"])
    c, h, w = task.data_params.in_shape
    k = task.data_params.out_shape[0]
    with torch.device(device):
        model = build_backbone(config["model_name"], (c, h, w), (k, h, w), **config["model"])
    made = weights_lib.make({n: v.shape for n, v in model.state_dict().items()}, seed, device,
                           init)
    model.load_state_dict(made)
    return task, model.eval(), made
