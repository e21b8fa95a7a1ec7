"""URDF ingestion (host-side) — the replacement for the kinematic half of
tesseract (reference dependency, SURVEY.md §1 "external robotics
substrate").

A copy of ``trajopt_tpu/kinematics/urdf.py`` (numpy only): the PyTorch
package imports nothing from the JAX package.

Parses a URDF XML string/file into a :class:`RobotModel` of plain numpy
arrays, from which :func:`build_chain` bakes a
:class:`~trajopt_tpu_torch.kinematics.chain.Chain` for a joint group (the
analog of ``tesseract::kinematics::JointGroup``).

Supported: revolute / continuous / prismatic / fixed joints, joint origins
(xyz + rpy), axes, position limits; collision geometry tags
sphere / box / cylinder / capsule (capsule via a non-standard ``<capsule>``
tag or cylinder approximation — see collision.world).  Meshes are recorded by
filename for offline convex decomposition but not loaded here.

Minimal SRDF support: ``<group><chain base_link tip_link/></group>`` and
``<disable_collisions>`` pairs.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np


@dataclasses.dataclass
class UrdfGeom:
    """One collision geometry attached to a link (local frame offset)."""

    kind: str  # "sphere" | "box" | "cylinder" | "capsule" | "mesh" | "convex"
    size: np.ndarray  # sphere: [r]; box: [x,y,z] full extents; cyl/capsule: [r, length]; convex: [sweep_r]
    xyz: np.ndarray  # (3,) offset in link frame
    rpy: np.ndarray  # (3,)
    mesh_file: Optional[str] = None
    verts: Optional[np.ndarray] = None  # convex/mesh: (V,3) hull vertices


@dataclasses.dataclass
class UrdfJoint:
    name: str
    jtype: str  # revolute | continuous | prismatic | fixed
    parent: str
    child: str
    xyz: np.ndarray
    rpy: np.ndarray
    axis: np.ndarray
    lower: float
    upper: float
    velocity: float


@dataclasses.dataclass
class RobotModel:
    name: str
    links: list[str]
    joints: list[UrdfJoint]
    geoms: dict[str, list[UrdfGeom]]  # link -> collision geoms
    groups: dict[str, list[str]] = dataclasses.field(default_factory=dict)
    disabled_pairs: set = dataclasses.field(default_factory=set)

    def joint(self, name: str) -> UrdfJoint:
        for j in self.joints:
            if j.name == name:
                return j
        raise KeyError(name)

    def child_joint_of(self, link: str) -> Optional[UrdfJoint]:
        for j in self.joints:
            if j.child == link:
                return j
        return None

    def actuated_joints(self) -> list[str]:
        return [j.name for j in self.joints if j.jtype != "fixed"]

    def chain_joints(self, base_link: str, tip_link: str) -> list[str]:
        """Actuated joint names on the base->tip path (SRDF chain groups)."""
        path = []
        link = tip_link
        while link != base_link:
            j = self.child_joint_of(link)
            if j is None:
                raise ValueError(f"no path from {tip_link} to {base_link}")
            if j.jtype != "fixed":
                path.append(j.name)
            link = j.parent
        return list(reversed(path))


def _floats(s: Optional[str], default):
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(v) for v in s.split()], dtype=np.float64)


def _parse_geom(el) -> Optional[UrdfGeom]:
    origin = el.find("origin")
    xyz = _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
    rpy = _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
    g = el.find("geometry")
    if g is None:
        return None
    for child in g:
        tag = child.tag
        if tag == "sphere":
            return UrdfGeom("sphere", _floats(child.get("radius"), [0]), xyz, rpy)
        if tag == "box":
            return UrdfGeom("box", _floats(child.get("size"), [0, 0, 0]), xyz, rpy)
        if tag in ("cylinder", "capsule"):
            r = float(child.get("radius", 0))
            ln = float(child.get("length", 0))
            return UrdfGeom(tag, np.array([r, ln]), xyz, rpy)
        if tag == "mesh":
            return UrdfGeom("mesh", np.zeros(3), xyz, rpy,
                            mesh_file=child.get("filename"))
    return None


def parse_urdf(xml_text: str) -> RobotModel:
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError:
        # xacro-generated URDFs use namespace prefixes (xacro:, tesseract:)
        # without declaring them; declare any undeclared prefix on the root
        # element so ElementTree accepts the document
        import re
        prefixes = set(re.findall(r"[\s<]([A-Za-z_][\w.-]*):[\w.-]+\s*=",
                                   xml_text))
        prefixes |= set(re.findall(r"<([A-Za-z_][\w.-]*):", xml_text))
        prefixes -= {"xml", "xmlns"}
        decls = "".join(
            f' xmlns:{p}="urn:x-undeclared:{p}"' for p in sorted(prefixes)
            if f"xmlns:{p}" not in xml_text)
        patched = re.sub(r"<robot(\s)", f"<robot{decls}\\1", xml_text,
                         count=1)
        root = ET.fromstring(patched)
    name = root.get("name", "robot")
    links, geoms = [], {}
    for link_el in root.findall("link"):
        lname = link_el.get("name")
        links.append(lname)
        gs = []
        for col in link_el.findall("collision"):
            g = _parse_geom(col)
            if g is not None:
                gs.append(g)
        geoms[lname] = gs
    joints = []
    for j in root.findall("joint"):
        jtype = j.get("type", "fixed")
        origin = j.find("origin")
        xyz = _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
        rpy = _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
        axis_el = j.find("axis")
        axis = _floats(axis_el.get("xyz") if axis_el is not None else None, [1, 0, 0])
        limit = j.find("limit")
        if limit is not None:
            lower = float(limit.get("lower", "0"))
            upper = float(limit.get("upper", "0"))
            vel = float(limit.get("velocity", "0"))
        else:
            lower, upper, vel = 0.0, 0.0, 0.0
        if jtype == "continuous":
            lower, upper = -2 * np.pi, 2 * np.pi
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        joints.append(UrdfJoint(j.get("name"), jtype, parent, child,
                                xyz, rpy, axis, lower, upper, vel))
    return RobotModel(name, links, joints, geoms)


def parse_urdf_file(path: str) -> RobotModel:
    with open(path) as f:
        return parse_urdf(f.read())


def parse_srdf(model: RobotModel, xml_text: str) -> RobotModel:
    """Attach SRDF groups (chains or explicit joint lists) + disabled pairs."""
    root = ET.fromstring(xml_text)
    for grp in root.findall("group"):
        gname = grp.get("name")
        chain = grp.find("chain")
        if chain is not None:
            model.groups[gname] = model.chain_joints(
                chain.get("base_link"), chain.get("tip_link"))
        else:
            model.groups[gname] = [j.get("name") for j in grp.findall("joint")]
    for dc in root.findall("disable_collisions"):
        a, b = dc.get("link1"), dc.get("link2")
        model.disabled_pairs.add(tuple(sorted((a, b))))
    return model
