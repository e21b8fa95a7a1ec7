"""Robot model zoo — freshly authored test/benchmark scenes.

Plays the role of the reference's URDF/SRDF fixtures
(trajopt_common/data/: spherebot, boxbot, PR2 arm scenes — SURVEY.md §4
"Fixtures").  These are NOT copies: they are minimal scenes with the same
*semantics* (a 2-DoF planar sphere robot vs a sphere obstacle, a 2-DoF
planar box robot for swept-collision tests, and a 7-DoF capsule arm standing
in for the PR2/iiwa-class arm used by the planning and glass-upright
benchmarks).

The URDF strings are byte-equal to ``trajopt_tpu/models/__init__.py``'s.
"""

from __future__ import annotations

from ..kinematics.urdf import parse_urdf, RobotModel
from ..kinematics.chain import build_chain, Chain

SPHEREBOT_URDF = """
<robot name="spherebot">
  <link name="world"/>
  <link name="slide_x"/>
  <link name="ball">
    <collision><geometry><sphere radius="0.5"/></geometry></collision>
  </link>
  <link name="obstacle">
    <collision><geometry><sphere radius="0.5"/></geometry></collision>
  </link>
  <joint name="x" type="prismatic">
    <parent link="world"/><child link="slide_x"/>
    <axis xyz="1 0 0"/><limit lower="-20" upper="20" velocity="2"/>
  </joint>
  <joint name="y" type="prismatic">
    <parent link="slide_x"/><child link="ball"/>
    <axis xyz="0 1 0"/><limit lower="-20" upper="20" velocity="2"/>
  </joint>
  <joint name="obstacle_fix" type="fixed">
    <origin xyz="0 0 0"/>
    <parent link="world"/><child link="obstacle"/>
  </joint>
</robot>
"""

BOXBOT_URDF = """
<robot name="boxbot">
  <link name="world"/>
  <link name="slide_x"/>
  <link name="box">
    <collision><geometry><box size="1 1 1"/></geometry></collision>
  </link>
  <link name="obstacle">
    <collision><geometry><box size="1 1 1"/></geometry></collision>
  </link>
  <joint name="x" type="prismatic">
    <parent link="world"/><child link="slide_x"/>
    <axis xyz="1 0 0"/><limit lower="-20" upper="20" velocity="2"/>
  </joint>
  <joint name="y" type="prismatic">
    <parent link="slide_x"/><child link="box"/>
    <axis xyz="0 1 0"/><limit lower="-20" upper="20" velocity="2"/>
  </joint>
  <joint name="obstacle_fix" type="fixed">
    <origin xyz="0 0 0"/>
    <parent link="world"/><child link="obstacle"/>
  </joint>
</robot>
"""

# A 7-DoF serial arm with alternating Z/Y revolute axes and capsule collision
# geometry (iiwa-like proportions) — the "glass-upright-class 7-DoF" flagship
# from BASELINE.json.  A table obstacle is a fixed box link.
ARM7_URDF = """
<robot name="arm7">
  <link name="base">
    <collision><origin xyz="0 0 0.075"/>
      <geometry><cylinder radius="0.10" length="0.15"/></geometry></collision>
  </link>
  <link name="l1">
    <collision><origin xyz="0 0 0.1"/>
      <geometry><capsule radius="0.08" length="0.20"/></geometry></collision>
  </link>
  <link name="l2">
    <collision><origin xyz="0 0 0.105"/>
      <geometry><capsule radius="0.07" length="0.21"/></geometry></collision>
  </link>
  <link name="l3">
    <collision><origin xyz="0 0 0.1"/>
      <geometry><capsule radius="0.07" length="0.20"/></geometry></collision>
  </link>
  <link name="l4">
    <collision><origin xyz="0 0 0.095"/>
      <geometry><capsule radius="0.06" length="0.19"/></geometry></collision>
  </link>
  <link name="l5">
    <collision><origin xyz="0 0 0.1"/>
      <geometry><capsule radius="0.06" length="0.20"/></geometry></collision>
  </link>
  <link name="l6">
    <collision><origin xyz="0 0 0.06"/>
      <geometry><capsule radius="0.05" length="0.12"/></geometry></collision>
  </link>
  <link name="l7">
    <collision><origin xyz="0 0 0.04"/>
      <geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <link name="tool"/>
  <link name="table">
    <collision><geometry><box size="0.8 1.2 0.06"/></geometry></collision>
  </link>

  <joint name="j1" type="revolute">
    <origin xyz="0 0 0.15"/><parent link="base"/><child link="l1"/>
    <axis xyz="0 0 1"/><limit lower="-2.96" upper="2.96" velocity="1.7"/>
  </joint>
  <joint name="j2" type="revolute">
    <origin xyz="0 0 0.20"/><parent link="l1"/><child link="l2"/>
    <axis xyz="0 1 0"/><limit lower="-2.09" upper="2.09" velocity="1.7"/>
  </joint>
  <joint name="j3" type="revolute">
    <origin xyz="0 0 0.21"/><parent link="l2"/><child link="l3"/>
    <axis xyz="0 0 1"/><limit lower="-2.96" upper="2.96" velocity="1.7"/>
  </joint>
  <joint name="j4" type="revolute">
    <origin xyz="0 0 0.20"/><parent link="l3"/><child link="l4"/>
    <axis xyz="0 1 0"/><limit lower="-2.09" upper="2.09" velocity="2.2"/>
  </joint>
  <joint name="j5" type="revolute">
    <origin xyz="0 0 0.19"/><parent link="l4"/><child link="l5"/>
    <axis xyz="0 0 1"/><limit lower="-2.96" upper="2.96" velocity="2.4"/>
  </joint>
  <joint name="j6" type="revolute">
    <origin xyz="0 0 0.20"/><parent link="l5"/><child link="l6"/>
    <axis xyz="0 1 0"/><limit lower="-2.09" upper="2.09" velocity="3.1"/>
  </joint>
  <joint name="j7" type="revolute">
    <origin xyz="0 0 0.126"/><parent link="l6"/><child link="l7"/>
    <axis xyz="0 0 1"/><limit lower="-3.05" upper="3.05" velocity="3.1"/>
  </joint>
  <joint name="tool_fix" type="fixed">
    <origin xyz="0 0 0.08"/><parent link="l7"/><child link="tool"/>
  </joint>
  <joint name="table_fix" type="fixed">
    <origin xyz="0.75 0 0.30"/><parent link="base"/><child link="table"/>
  </joint>
</robot>
"""


# Pick-and-place variant: the same 7-DoF arm, but the obstacle is a divider
# WALL between the pick side (y < 0) and the place side (y > 0) — the
# BASELINE pick-and-place config's geometry (grasped payload must be carried
# over an obstacle between two chained problems; reference analog:
# trajopt/test/cast_cost_attached_unit.cpp worlds).
ARM7_WALL_URDF = ARM7_URDF.replace(
    '<link name="table">\n'
    '    <collision><geometry><box size="0.8 1.2 0.06"/></geometry>'
    '</collision>\n'
    '  </link>',
    '<link name="table">\n'
    '    <collision><geometry><box size="0.45 0.07 0.45"/></geometry>'
    '</collision>\n'
    '  </link>'
).replace(
    '<origin xyz="0.75 0 0.30"/><parent link="base"/><child link="table"/>',
    '<origin xyz="0.60 0 0.50"/><parent link="base"/><child link="table"/>')

# 9-DoF redundant-axes variant: the 7-DoF arm riding a 2-axis prismatic
# gantry (external axes), with a world-fixed overhead shelf the ARM (not
# the gantry column — whose height no dof can change) sweeps through on
# the straight-line carriage motion — the BASELINE "continuous collision
# with redundant external axes, 9-DOF" config.
ARM9_RAIL_URDF = ARM7_URDF.replace(
    '<collision><geometry><box size="0.8 1.2 0.06"/></geometry></collision>',
    '<collision><geometry><box size="0.45 1.2 0.30"/></geometry></collision>'
).replace(
    '<robot name="arm7">',
    '<robot name="arm9_rail">\n'
    '  <link name="rail"/>\n'
    '  <link name="carriage"/>\n'
    '  <joint name="railx" type="prismatic">\n'
    '    <parent link="rail"/><child link="carriage"/>\n'
    '    <axis xyz="1 0 0"/>'
    '<limit lower="-0.9" upper="0.9" velocity="1.0"/>\n'
    '  </joint>\n'
    '  <joint name="raily" type="prismatic">\n'
    '    <parent link="carriage"/><child link="base"/>\n'
    '    <axis xyz="0 1 0"/>'
    '<limit lower="-0.45" upper="0.45" velocity="1.0"/>\n'
    '  </joint>'
).replace(
    '<origin xyz="0.75 0 0.30"/><parent link="base"/><child link="table"/>',
    '<origin xyz="0.45 0 0.65"/><parent link="rail"/><child link="table"/>')


def spherebot() -> tuple[RobotModel, Chain]:
    m = parse_urdf(SPHEREBOT_URDF)
    return m, build_chain(m, ["x", "y"])


def boxbot() -> tuple[RobotModel, Chain]:
    m = parse_urdf(BOXBOT_URDF)
    return m, build_chain(m, ["x", "y"])


def arm7() -> tuple[RobotModel, Chain]:
    m = parse_urdf(ARM7_URDF)
    return m, build_chain(m, [f"j{i}" for i in range(1, 8)])


def arm7_wall() -> tuple[RobotModel, Chain]:
    m = parse_urdf(ARM7_WALL_URDF)
    return m, build_chain(m, [f"j{i}" for i in range(1, 8)])


def arm9_rail() -> tuple[RobotModel, Chain]:
    m = parse_urdf(ARM9_RAIL_URDF)
    return m, build_chain(m, ["railx", "raily"] + [f"j{i}" for i in range(1, 8)])
