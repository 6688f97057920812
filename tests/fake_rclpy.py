"""In-process rclpy / ROS2 message stubs so ``node.py``'s runtime body can be
exercised without a ROS2 installation.

The shim reproduces exactly the API surface the node touches (reference
scripts/3d_mapper_node.py:45-556): parameter declaration with overrides,
publishers, wall timers, clock, logger, QoS enums, the sensor/nav/geometry/
visualization message classes as plain attribute bags, a recording
StaticTransformBroadcaster, and a ``message_filters`` whose
ApproximateTimeSynchronizer delegates to the REAL pairing algorithm
(io/timesync.ApproximateTimeSync — the line-faithful message_filters port),
so tests drive the node's ingest path through the same synchronizer
semantics a live ROS graph would.

Usage:
    mods = fake_rclpy.install()          # sys.modules gets the stubs
    node_mod = importlib.reload(node)    # node imports resolve to the stubs
    ... drive ...
    fake_rclpy.uninstall(mods)
    importlib.reload(node)               # restore the rclpy-less module
"""

from __future__ import annotations

import importlib
import sys
import types
from typing import Any, Dict, List, Optional

from sonar_3d_reconstruction_tpu.io.timesync import ApproximateTimeSync


# ---------------------------------------------------------------------------
# Messages: attribute bags with ROS2-shaped defaults
# ---------------------------------------------------------------------------

class _Obj:
    """Generic nested attribute bag (pose.pose.position.x and friends)."""

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class Stamp:
    def __init__(self, sec: int = 0, nanosec: int = 0):
        self.sec = sec
        self.nanosec = nanosec


class Header:
    def __init__(self, stamp: Optional[Stamp] = None, frame_id: str = ""):
        self.stamp = stamp or Stamp()
        self.frame_id = frame_id


class Image:
    def __init__(self, **kw):
        self.header = Header()
        self.height = 0
        self.width = 0
        self.encoding = "mono8"
        self.is_bigendian = False
        self.step = 0
        self.data = b""
        for k, v in kw.items():
            setattr(self, k, v)


class PointField:
    def __init__(self, name="", offset=0, datatype=0, count=0):
        self.name, self.offset, self.datatype, self.count = (
            name, offset, datatype, count
        )


class PointCloud2:
    def __init__(self):
        self.header = Header()
        self.height = 0
        self.width = 0
        self.fields: List[PointField] = []
        self.is_bigendian = False
        self.point_step = 0
        self.row_step = 0
        self.data = b""
        self.is_dense = False


class Odometry:
    def __init__(self, position=(0.0, 0.0, 0.0), quaternion=(0.0, 0.0, 0.0, 1.0)):
        self.header = Header()
        self.child_frame_id = ""
        self.pose = _Obj(
            pose=_Obj(
                position=_Obj(
                    x=position[0], y=position[1], z=position[2]
                ),
                orientation=_Obj(
                    x=quaternion[0], y=quaternion[1],
                    z=quaternion[2], w=quaternion[3],
                ),
            )
        )


class Point:
    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = x, y, z


class TransformStamped:
    def __init__(self):
        self.header = Header()
        self.child_frame_id = ""
        self.transform = _Obj(
            translation=_Obj(x=0.0, y=0.0, z=0.0),
            rotation=_Obj(x=0.0, y=0.0, z=0.0, w=1.0),
        )


class Marker:
    CUBE_LIST = 6
    ADD = 0

    def __init__(self):
        self.header = Header()
        self.ns = ""
        self.id = 0
        self.type = 0
        self.action = 0
        self.scale = _Obj(x=0.0, y=0.0, z=0.0)
        self.color = _Obj(r=0.0, g=0.0, b=0.0, a=0.0)
        self.points: List[Point] = []


class MarkerArray:
    def __init__(self):
        self.markers: List[Marker] = []


# ---------------------------------------------------------------------------
# rclpy core
# ---------------------------------------------------------------------------

class Logger:
    def __init__(self):
        self.records: List[tuple] = []

    def info(self, msg: str) -> None:
        self.records.append(("info", msg))

    def warning(self, msg: str) -> None:
        self.records.append(("warning", msg))

    def error(self, msg: str) -> None:
        self.records.append(("error", msg))


class _Time:
    def __init__(self, sec: int, nanosec: int):
        self._sec, self._nanosec = sec, nanosec

    def to_msg(self) -> Stamp:
        return Stamp(self._sec, self._nanosec)


class Clock:
    """Deterministic, test-settable clock."""

    def __init__(self):
        self.sec = 100
        self.nanosec = 0

    def now(self) -> _Time:
        return _Time(self.sec, self.nanosec)


class Publisher:
    def __init__(self, msg_type, topic: str, depth: int):
        self.msg_type = msg_type
        self.topic = topic
        self.depth = depth
        self.published: List[Any] = []

    def publish(self, msg) -> None:
        self.published.append(msg)


class Timer:
    def __init__(self, period_sec: float, callback):
        self.period_sec = period_sec
        self.callback = callback

    def fire(self) -> None:
        self.callback()


class Parameter:
    def __init__(self, value):
        self.value = value


class Node:
    """rclpy.node.Node stub.  Set ``Node.parameter_overrides`` (class attr)
    before construction to emulate --params-file / -p layering."""

    parameter_overrides: Dict[str, Any] = {}

    def __init__(self, name: str):
        self.node_name = name
        self._params: Dict[str, Parameter] = {}
        self.publishers: List[Publisher] = []
        self.timers: List[Timer] = []
        self._logger = Logger()
        self._clock = Clock()
        self.destroyed = False

    def declare_parameter(self, name: str, default):
        value = self.parameter_overrides.get(name, default)
        self._params[name] = Parameter(value)
        return self._params[name]

    def get_parameter(self, name: str) -> Parameter:
        return self._params[name]

    def create_publisher(self, msg_type, topic: str, depth: int) -> Publisher:
        pub = Publisher(msg_type, topic, depth)
        self.publishers.append(pub)
        return pub

    def create_timer(self, period_sec: float, callback) -> Timer:
        t = Timer(period_sec, callback)
        self.timers.append(t)
        return t

    def get_logger(self) -> Logger:
        return self._logger

    def get_clock(self) -> Clock:
        return self._clock

    def destroy_node(self) -> None:
        self.destroyed = True


class QoSProfile:
    def __init__(self, reliability=None, history=None, depth=0):
        self.reliability = reliability
        self.history = history
        self.depth = depth


class ReliabilityPolicy:
    BEST_EFFORT = "best_effort"
    RELIABLE = "reliable"


class HistoryPolicy:
    KEEP_LAST = "keep_last"
    KEEP_ALL = "keep_all"


class StaticTransformBroadcaster:
    def __init__(self, node: Node):
        self.node = node
        self.sent: List[TransformStamped] = []
        # park on the node so tests can reach it after _publish_static_tf
        node.static_tf_broadcasters = getattr(
            node, "static_tf_broadcasters", []
        )
        node.static_tf_broadcasters.append(self)

    def sendTransform(self, transform: TransformStamped) -> None:
        self.sent.append(transform)


# ---------------------------------------------------------------------------
# message_filters: Subscriber + ApproximateTimeSynchronizer delegating to the
# real io/timesync pairing algorithm
# ---------------------------------------------------------------------------

class Subscriber:
    def __init__(self, node: Node, msg_type, topic: str, qos_profile=None):
        self.node = node
        self.msg_type = msg_type
        self.topic = topic
        self.qos_profile = qos_profile
        self._sync: Optional["ApproximateTimeSynchronizer"] = None
        self._index = -1

    def deliver(self, msg) -> None:
        """Test hook standing in for DDS delivery of one message."""
        assert self._sync is not None, "no synchronizer registered"
        stamp = msg.header.stamp.sec + 1e-9 * msg.header.stamp.nanosec
        self._sync._arrive(self._index, msg, stamp)


class ApproximateTimeSynchronizer:
    """Wraps the package's line-faithful message_filters port so the node's
    callback fires exactly when a live graph's would."""

    def __init__(self, subscribers, queue_size: int = 10, slop: float = 0.1):
        assert len(subscribers) == 2, "shim supports the node's 2-topic sync"
        self.subscribers = list(subscribers)
        self.queue_size = queue_size
        self.slop = slop
        self._callbacks: List[Any] = []
        self._sync: Optional[ApproximateTimeSync] = None
        for i, sub in enumerate(self.subscribers):
            sub._sync = self
            sub._index = i

    def registerCallback(self, cb) -> None:
        self._callbacks.append(cb)
        if self._sync is None:
            self._sync = ApproximateTimeSync(
                self._fire, queue_size=self.queue_size, slop=self.slop
            )

    def _fire(self, msg0, msg1) -> None:
        for cb in self._callbacks:
            cb(msg0, msg1)

    def _arrive(self, index: int, msg, stamp: float) -> None:
        assert self._sync is not None
        if index == 0:
            self._sync.add_ping(msg, stamp)
        else:
            self._sync.add_pose(msg, stamp)


# ---------------------------------------------------------------------------
# module assembly
# ---------------------------------------------------------------------------

_SHIM_MODULES = [
    "rclpy", "rclpy.node", "rclpy.qos",
    "sensor_msgs", "sensor_msgs.msg",
    "nav_msgs", "nav_msgs.msg",
    "geometry_msgs", "geometry_msgs.msg",
    "visualization_msgs", "visualization_msgs.msg",
    "tf2_ros", "message_filters",
]


def _module(name: str, **attrs) -> types.ModuleType:
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def install() -> Dict[str, Optional[types.ModuleType]]:
    """Install the stub modules; returns the displaced entries for uninstall."""
    spin_state = {"hook": None, "initialized": False, "shutdown": False}

    def init(args=None):
        spin_state["initialized"] = True

    def spin(node):
        hook = spin_state["hook"]
        if hook is not None:
            hook(node)

    def shutdown():
        spin_state["shutdown"] = True

    rclpy_mod = _module(
        "rclpy", init=init, spin=spin, shutdown=shutdown, _state=spin_state
    )
    rclpy_mod.node = _module("rclpy.node", Node=Node)
    rclpy_mod.qos = _module(
        "rclpy.qos",
        QoSProfile=QoSProfile,
        ReliabilityPolicy=ReliabilityPolicy,
        HistoryPolicy=HistoryPolicy,
    )

    mods = {
        "rclpy": rclpy_mod,
        "rclpy.node": rclpy_mod.node,
        "rclpy.qos": rclpy_mod.qos,
        "sensor_msgs": _module("sensor_msgs"),
        "sensor_msgs.msg": _module(
            "sensor_msgs.msg",
            Image=Image, PointCloud2=PointCloud2, PointField=PointField,
        ),
        "nav_msgs": _module("nav_msgs"),
        "nav_msgs.msg": _module("nav_msgs.msg", Odometry=Odometry),
        "geometry_msgs": _module("geometry_msgs"),
        "geometry_msgs.msg": _module(
            "geometry_msgs.msg", Point=Point, TransformStamped=TransformStamped,
        ),
        "visualization_msgs": _module("visualization_msgs"),
        "visualization_msgs.msg": _module(
            "visualization_msgs.msg", Marker=Marker, MarkerArray=MarkerArray,
        ),
        "tf2_ros": _module(
            "tf2_ros", StaticTransformBroadcaster=StaticTransformBroadcaster
        ),
        "message_filters": _module(
            "message_filters",
            Subscriber=Subscriber,
            ApproximateTimeSynchronizer=ApproximateTimeSynchronizer,
        ),
    }
    displaced = {name: sys.modules.get(name) for name in _SHIM_MODULES}
    sys.modules.update(mods)
    return displaced


def uninstall(displaced: Dict[str, Optional[types.ModuleType]]) -> None:
    for name in _SHIM_MODULES:
        prev = displaced.get(name)
        if prev is None:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = prev


def reload_node():
    """(Re)import sonar_3d_reconstruction_tpu.node under current sys.modules."""
    import sonar_3d_reconstruction_tpu.node as node_mod

    return importlib.reload(node_mod)
