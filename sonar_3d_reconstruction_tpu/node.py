"""Thin ROS2 node wrapping the JAX pipeline (optional; import-guarded).

Reproduces the reference node's runtime surface
(scripts/3d_mapper_node.py:45-556): subscribes the sonar Image + Fast-LIO
Odometry topics through an ApproximateTimeSynchronizer (queue 10, slop 0.1 s,
Best-Effort QoS depth 10), maps pings on device, publishes the occupied map
as PointCloud2 (probability in the intensity field) on a fixed-rate wall
timer, optionally publishes classified CUBE_LIST markers and the static
base->sonar TF.

rclpy is NOT a dependency of this package: importing this module without a
ROS2 environment raises ImportError only when ``main``/``SonarMapperNode``
is actually used.

Run:  python -m sonar_3d_reconstruction_tpu.node --ros-args --params-file config.yaml
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np

try:  # pragma: no cover - exercised only inside a ROS2 environment
    import rclpy
    from rclpy.node import Node
    from rclpy.qos import QoSProfile, ReliabilityPolicy, HistoryPolicy
    from sensor_msgs.msg import Image, PointCloud2, PointField
    from nav_msgs.msg import Odometry
    from geometry_msgs.msg import Point, TransformStamped
    from visualization_msgs.msg import Marker, MarkerArray
    from tf2_ros import StaticTransformBroadcaster
    import message_filters

    _ROS2 = True
except ImportError:  # pragma: no cover
    _ROS2 = False
    Node = object  # type: ignore[assignment,misc]

from sonar_3d_reconstruction_tpu.config import MapperConfig, StreamConfig, load_config
from sonar_3d_reconstruction_tpu.geometry import quaternion_from_rpy
from sonar_3d_reconstruction_tpu.io.image import decode_image
from sonar_3d_reconstruction_tpu.io.pointcloud import (
    classified_markers,
    serialize_pointcloud2,
)
from sonar_3d_reconstruction_tpu.models import SonarMapper


# Parameters the node declares, in the reference node's names and units
# (scripts/3d_mapper_node.py:53-107; orientation in DEGREES at this level).
_NODE_PARAM_DEFAULTS: Dict[str, Any] = {
    "horizontal_fov": 130.0,
    "vertical_aperture": 20.0,
    "max_range": 10.0,
    "min_range": 0.5,
    "intensity_threshold": 35,
    "image_width": 512,
    "image_height": 500,
    "sonar_position.x": 0.0,
    "sonar_position.y": 0.0,
    "sonar_position.z": -0.5,
    "sonar_orientation.roll": 0.0,
    "sonar_orientation.pitch": 90.0,
    "sonar_orientation.yaw": 0.0,
    "voxel_resolution": 0.05,
    "min_probability": 0.6,
    "dynamic_expansion": True,
    "z_filter_min": -5.0,
    "z_filter_enabled": True,
    "adaptive_update": True,
    "adaptive_threshold": 0.5,
    "adaptive_max_ratio": 0.3,
    "log_odds_occupied": 1.5,
    "log_odds_free": -2.0,
    "log_odds_min": -10.0,
    "log_odds_max": 10.0,
    "show_free_space": False,
    "sonar_frame_id": "sonar_link",
    "base_frame_id": "base_link",
    "map_frame_id": "map",
    "publish_tf": True,
    "sonar_topic": "/sensor/sonar/oculus/m750d/image",
    "odometry_topic": "/fast_lio/odometry",
    "pointcloud_topic": "/sonar_3d_map",
    "marker_topic": "/sonar_3d_map_markers",
    "publish_rate_hz": 10.0,
    # reference node:105 (read :154, used per frame :338-339; prod config
    # enables it, config/3d_mapper.yaml:62)
    "show_opencv_visualization": False,
    # EXTENSION beyond the reference's declared set: select the device map
    # backend (hash | brick | brick-sharded | dense).  Default preserves
    # the reference-parity hash behavior.
    "map_backend": "hash",
}


class SonarMapperNode(Node):  # pragma: no cover - needs a ROS2 environment
    """ROS2 front-end; all mapping happens in the device SonarMapper."""

    def __init__(self) -> None:
        if not _ROS2:
            raise ImportError(
                "rclpy is not available — the ROS2 node requires a ROS2 "
                "environment; use the CLI (map-bag) for ROS-free replay"
            )
        super().__init__("sonar_3d_mapper")
        for name, default in _NODE_PARAM_DEFAULTS.items():
            self.declare_parameter(name, default)

        p = lambda name: self.get_parameter(name).value  # noqa: E731
        # deg->rad happens exactly once here (reference node:130-132)
        lib_config = {
            k: p(k)
            for k in (
                "horizontal_fov", "vertical_aperture", "max_range", "min_range",
                "intensity_threshold", "image_width", "image_height",
                "voxel_resolution", "min_probability", "dynamic_expansion",
                "z_filter_min", "z_filter_enabled", "adaptive_update",
                "adaptive_threshold", "adaptive_max_ratio", "log_odds_occupied",
                "log_odds_free", "log_odds_min", "log_odds_max",
            )
        }
        lib_config["sonar_position"] = [
            p("sonar_position.x"), p("sonar_position.y"), p("sonar_position.z")
        ]
        lib_config["sonar_orientation"] = [
            math.radians(p("sonar_orientation.roll")),
            math.radians(p("sonar_orientation.pitch")),
            math.radians(p("sonar_orientation.yaw")),
        ]
        self.mapper = SonarMapper(lib_config, backend=str(p("map_backend")))
        self.show_free_space = bool(p("show_free_space"))
        self.show_opencv_visualization = bool(p("show_opencv_visualization"))
        self.map_frame_id = str(p("map_frame_id"))

        if bool(p("publish_tf")):
            self._publish_static_tf(
                str(p("base_frame_id")), str(p("sonar_frame_id")),
                lib_config["sonar_position"], lib_config["sonar_orientation"],
            )

        qos = QoSProfile(
            reliability=ReliabilityPolicy.BEST_EFFORT,
            history=HistoryPolicy.KEEP_LAST,
            depth=10,
        )
        sonar_sub = message_filters.Subscriber(
            self, Image, str(p("sonar_topic")), qos_profile=qos
        )
        odom_sub = message_filters.Subscriber(
            self, Odometry, str(p("odometry_topic")), qos_profile=qos
        )
        self._sync = message_filters.ApproximateTimeSynchronizer(
            [sonar_sub, odom_sub], queue_size=10, slop=0.1
        )
        self._sync.registerCallback(self.synchronized_callback)

        self.pc_pub = self.create_publisher(
            PointCloud2, str(p("pointcloud_topic")), 10
        )
        self.marker_pub = self.create_publisher(
            MarkerArray, str(p("marker_topic")), 10
        )
        self.create_timer(1.0 / float(p("publish_rate_hz")), self.publish_map)
        self.get_logger().info(
            f"sonar_3d_mapper up: res={lib_config['voxel_resolution']} m, "
            f"fov={lib_config['horizontal_fov']} deg (JAX backend)"
        )

    # -- ingest ---------------------------------------------------------
    def synchronized_callback(self, image_msg, odom_msg) -> None:
        try:
            img = decode_image(
                bytes(image_msg.data),
                image_msg.height,
                image_msg.width,
                image_msg.encoding,
                image_msg.step,
                image_msg.is_bigendian,
            )
        except Exception as e:  # drop-and-log ANY decode failure (node:313-316)
            self.get_logger().error(f"image decode failed: {e}")
            return
        # per-frame threshold overlay (reference node:338-339 calling
        # visualize_with_threshold :249-292); headless-safe — debugviz.show
        # only opens a window when OpenCV is importable
        if self.show_opencv_visualization:
            from sonar_3d_reconstruction_tpu.io import debugviz

            self.last_debug_overlay = debugviz.show(img, self.mapper.cfg)
        pos = odom_msg.pose.pose.position
        q = odom_msg.pose.pose.orientation
        stats = self.mapper.process_sonar_image(
            img, [pos.x, pos.y, pos.z], [q.x, q.y, q.z, q.w]
        )
        if stats["frame_count"] % 10 == 0:  # periodic log (node:345-357)
            skew = abs(
                (image_msg.header.stamp.sec + image_msg.header.stamp.nanosec * 1e-9)
                - (odom_msg.header.stamp.sec + odom_msg.header.stamp.nanosec * 1e-9)
            )
            self.get_logger().info(
                f"frame {stats['frame_count']}: voxels={stats['num_voxels']} "
                f"({stats['processing_time']*1e3:.1f} ms, skew {skew*1e3:.0f} ms)"
            )

    # -- publish ----------------------------------------------------------
    def publish_map(self) -> None:
        now = self.get_clock().now().to_msg()
        cloud = self.mapper.get_point_cloud(include_free=self.show_free_space)
        if self.show_free_space:
            occupied = cloud["occupied"]
            points, probs = occupied
            self._publish_markers(cloud, now)
        else:
            points, probs = cloud["points"], cloud["probabilities"]
        d = serialize_pointcloud2(
            np.asarray(points, np.float64).reshape(-1, 3),
            np.asarray(probs, np.float64).reshape(-1),
            frame_id=self.map_frame_id,
            stamp=(now.sec, now.nanosec),
        )
        msg = PointCloud2()
        msg.header.frame_id = self.map_frame_id
        msg.header.stamp = now
        msg.height = d["height"]
        msg.width = d["width"]
        msg.fields = [
            PointField(
                name=f["name"], offset=f["offset"],
                datatype=f["datatype"], count=f["count"],
            )
            for f in d["fields"]
        ]
        msg.is_bigendian = d["is_bigendian"]
        msg.point_step = d["point_step"]
        msg.row_step = d["row_step"]
        msg.data = d["data"]
        msg.is_dense = d["is_dense"]
        self.pc_pub.publish(msg)

    def _publish_markers(self, cloud, now) -> None:
        classified = {
            k: cloud[k] for k in ("occupied", "free", "unknown")
        }
        arr = MarkerArray()
        for md in classified_markers(
            classified, self.mapper.cfg.voxel_resolution, self.map_frame_id,
            (now.sec, now.nanosec),
        ):
            m = Marker()
            m.header.frame_id = md["header"]["frame_id"]
            m.header.stamp = now
            m.ns = md["ns"]
            m.id = md["id"]
            m.type = md["type"]
            m.action = md["action"]
            m.scale.x, m.scale.y, m.scale.z = (
                md["scale"]["x"], md["scale"]["y"], md["scale"]["z"]
            )
            c = md["color"]
            m.color.r, m.color.g, m.color.b, m.color.a = (
                c["r"], c["g"], c["b"], c["a"]
            )
            # intended behavior behind the reference's marker.points.add()
            # defect (node:475): append a Point per voxel center
            m.points = [Point(x=float(x), y=float(y), z=float(z))
                        for x, y, z in md["points"]]
            arr.markers.append(m)
        self.marker_pub.publish(arr)

    def _publish_static_tf(self, base, sonar, position, rpy) -> None:
        t = TransformStamped()
        t.header.stamp = self.get_clock().now().to_msg()
        t.header.frame_id = base
        t.child_frame_id = sonar
        t.transform.translation.x = float(position[0])
        t.transform.translation.y = float(position[1])
        t.transform.translation.z = float(position[2])
        q = quaternion_from_rpy(np.asarray(rpy))
        t.transform.rotation.x = float(q[0])
        t.transform.rotation.y = float(q[1])
        t.transform.rotation.z = float(q[2])
        t.transform.rotation.w = float(q[3])
        self._tf_broadcaster = StaticTransformBroadcaster(self)
        self._tf_broadcaster.sendTransform(t)


def main(args=None) -> None:  # pragma: no cover
    if not _ROS2:
        raise SystemExit(
            "rclpy not found — this entry point needs a ROS2 environment"
        )
    rclpy.init(args=args)
    node = SonarMapperNode()
    try:
        rclpy.spin(node)
    except KeyboardInterrupt:
        pass
    finally:
        cloud = node.mapper.get_point_cloud()
        node.get_logger().info(
            f"final map: {cloud['num_occupied']} occupied / "
            f"{cloud['num_voxels']} voxels over {cloud['frame_count']} frames"
        )
        node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
