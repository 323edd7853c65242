"""Robot model container: the fixed kinematic tree as tensors.

Port of ``hunter_bipedal_control_tpu/models/robot.py``.  The topology
index arrays (``joint_parent``, ``joint_child``, ``frame_parent``,
``contact_frame_ids``) are int64 tensors kept on the host, the counterpart
of the JAX model's static numpy fields: kinematics loops read them as
Python ints.  Every float field lives on the model's device in its dtype.

Conventions (see models/spatial.py):
    q = [base pos world (3), base ZYX euler (3), joint angles (nj)]
    v = [base lin vel world (3), euler rates (3), joint velocities (nj)]
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")

GRAVITY = 9.81

INDEX_FIELDS = ("joint_parent", "joint_child", "frame_parent", "contact_frame_ids")


class RobotModel(NamedTuple):
    """Fixed-topology floating-base model (field names as in the JAX package)."""

    # --- static topology ---
    nj: int
    n_links: int
    joint_parent: torch.Tensor     # (nj,) int64, host
    joint_child: torch.Tensor      # (nj,) int64, host
    ancestor_mask: torch.Tensor    # (n_links, nj) 1.0 if joint j is on path root->link
    link_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    frame_names: Tuple[str, ...]
    frame_parent: torch.Tensor     # (nf,) int64, host
    contact_frame_ids: torch.Tensor  # (nc,) int64, host
    contact_names: Tuple[str, ...]

    # --- parameters ---
    joint_origin_pos: torch.Tensor  # (nj, 3)
    joint_origin_rot: torch.Tensor  # (nj, 3, 3)
    joint_axis: torch.Tensor        # (nj, 3)
    link_mass: torch.Tensor         # (n_links,)
    link_com: torch.Tensor          # (n_links, 3)
    link_inertia: torch.Tensor      # (n_links, 3, 3)
    frame_pos: torch.Tensor         # (nf, 3)
    frame_rot: torch.Tensor         # (nf, 3, 3)
    joint_lower: torch.Tensor       # (nj,)
    joint_upper: torch.Tensor
    joint_effort: torch.Tensor
    joint_vel_limit: torch.Tensor
    total_mass: torch.Tensor        # scalar

    @property
    def nq(self) -> int:
        return 6 + self.nj

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def num_contacts(self) -> int:
        return int(self.contact_frame_ids.shape[0])


def load_model(spec_path: str | None = None, device=None,
               dtype=torch.float32) -> RobotModel:
    """Load a RobotModel from a JSON spec (default: the bundled Hunter biped)."""
    dev = resolve_device(device)
    if spec_path is None:
        spec_path = os.path.join(_ASSET_DIR, "hunter_model.json")
    with open(spec_path) as f:
        spec = json.load(f)

    links = spec["links"]
    joints = spec["joints"]
    frames = spec["frames"]
    n_links = len(links)
    nj = len(joints)

    link_index = {l["name"]: i for i, l in enumerate(links)}
    joint_child = np.array([link_index[j["child_link"]] for j in joints], dtype=np.int64)
    joint_parent = np.array([j["parent"] for j in joints], dtype=np.int64)

    # joint j moves link k iff child(j) is an ancestor of k (or k itself)
    parent_of_link = np.full(n_links, -1, dtype=np.int64)
    joint_of_link = np.full(n_links, -1, dtype=np.int64)
    for j in range(nj):
        parent_of_link[joint_child[j]] = joint_parent[j]
        joint_of_link[joint_child[j]] = j
    ancestor_mask = np.zeros((n_links, nj), dtype=np.float64)
    for k in range(n_links):
        cur = k
        while cur != 0 and cur != -1:
            ancestor_mask[k, joint_of_link[cur]] = 1.0
            cur = parent_of_link[cur]

    frame_parent = np.array([f["parent"] for f in frames], dtype=np.int64)
    frame_names = tuple(f["name"] for f in frames)
    contact_names = tuple(spec["contacts"])
    contact_frame_ids = np.array([frame_names.index(c) for c in contact_names], dtype=np.int64)

    def arr(x):
        return torch.as_tensor(np.array(x, dtype=np.float64), dtype=dtype, device=dev)

    return RobotModel(
        nj=nj,
        n_links=n_links,
        joint_parent=torch.from_numpy(joint_parent),
        joint_child=torch.from_numpy(joint_child),
        ancestor_mask=arr(ancestor_mask),
        link_names=tuple(l["name"] for l in links),
        joint_names=tuple(j["name"] for j in joints),
        frame_names=frame_names,
        frame_parent=torch.from_numpy(frame_parent),
        contact_frame_ids=torch.from_numpy(contact_frame_ids),
        contact_names=contact_names,
        joint_origin_pos=arr([j["origin_xyz"] for j in joints]),
        joint_origin_rot=arr([j["origin_rot"] for j in joints]),
        joint_axis=arr([j["axis"] for j in joints]),
        link_mass=arr([l["mass"] for l in links]),
        link_com=arr([l["com"] for l in links]),
        link_inertia=arr([l["inertia"] for l in links]),
        frame_pos=arr([f["origin_xyz"] for f in frames]),
        frame_rot=arr([f["origin_rot"] for f in frames]),
        joint_lower=arr([j["lower"] for j in joints]),
        joint_upper=arr([j["upper"] for j in joints]),
        joint_effort=arr([j["effort"] for j in joints]),
        joint_vel_limit=arr([j["velocity"] for j in joints]),
        total_mass=arr(sum(l["mass"] for l in links)),
    )
