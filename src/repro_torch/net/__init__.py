from repro_torch.net.topology import (  # noqa: F401
    Link,
    LinkKind,
    LinkSchedule,
    RouteSchedule,
    Topology,
    big_switch,
    diurnal_schedule,
    fat_tree,
    link_failure_schedule,
    tpu_pod_fabric,
)
