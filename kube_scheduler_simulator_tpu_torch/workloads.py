"""Seeded synthetic clusters: the benchmark's node and pod generators.

``mk_node`` / ``mk_pod`` are the generators of the JAX package's bench
(BASELINE cfg1-cfg5 shapes: 64-core / 256 Gi nodes in 8 zones, every 16th
node carrying a PreferNoSchedule taint; pods of 100m-1000m CPU and
128-1024 Mi memory, every 4th with a nodeSelector; bench's two spread
constraints and its preferred podAntiAffinity on request).  ``cluster``
builds a whole seeded snapshot and adds the features the port's other
filters and scores read (NoSchedule taints and tolerations, an
unschedulable node, a nodeName-pinned pod, container images on nodes and
pods), all drawn from the same seed.  ``add_host_ports`` and
``add_volumes`` give such a snapshot the host ports, claims, volumes and
CSI nodes a StatefulSet- and DaemonSet-heavy cluster carries (the
``volumes`` dict that ``BatchEngine.schedule(..., volumes=)`` reads).
``churn`` replays the bench's BASELINE cfg5 scenario churn into a cluster
store, wave by wave, with a rolling cordon on top; ``stream_cluster`` and
``steady_feed`` build cfg9-stream's standing cluster and its arrival
stream.  ``preemption_wave``
fills a store with cfg7-preempt-5k, Kubernetes scheduler_perf's
PreemptionBasic shape at its 5000Nodes size.  ``gang_churn`` replays the
JAX package's cfg8-gang (bench ``run_gang``): distributed-training jobs,
each a PodGroup of one-CPU members, arriving in waves and completing.
``autoscale`` builds the JAX package's cfg6-autoscale (bench
``run_autoscale``): a few seed nodes, three node groups and a backlog of
pending pods; ``autoscale_burst`` one scale-up estimate's groups and
pods against many pools.  ``tune`` gives the weight tuner's scenario
families (tuning/scenario.py) at a size: cfg10-tune-10k.
"""

from __future__ import annotations

import collections
import random


def mk_node(i: int, zones: int = 8) -> dict:
    return {
        "metadata": {
            "name": f"node-{i}",
            "labels": {
                "topology.kubernetes.io/zone": f"zone-{i % zones}",
                "kubernetes.io/hostname": f"node-{i}",
                "disk": "ssd" if i % 2 else "hdd",
            },
        },
        "spec": (
            {"taints": [{"key": "spot", "value": "true", "effect": "PreferNoSchedule"}]}
            if i % 16 == 0
            else {}
        ),
        "status": {"allocatable": {"cpu": "64000m", "memory": "256Gi", "pods": "512"}},
    }


def _interpod_affinity(i: int) -> dict:
    """Pod i's inter-pod terms: bench's preferred anti-affinity on hostname
    for odd pods (weight 10, against its own app), a required
    anti-affinity on hostname against its own app for every 25th pod, and
    a required affinity to a ``tier=web`` pod's zone for pods 20, 60, ..."""
    app = {"matchLabels": {"app": f"app-{i % 8}"}}
    aff: dict = {}
    anti: dict = {}
    if i % 2:
        anti["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": 10, "podAffinityTerm": {"labelSelector": app, "topologyKey": "kubernetes.io/hostname"}}
        ]
    if i % 25 == 0:
        anti["requiredDuringSchedulingIgnoredDuringExecution"] = [
            {"labelSelector": app, "topologyKey": "kubernetes.io/hostname"}
        ]
    if i % 40 == 20:
        aff["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"tier": "web"}}, "topologyKey": "topology.kubernetes.io/zone"}
            ]
        }
    if anti:
        aff["podAntiAffinity"] = anti
    return aff


def mk_pod(i: int, rng: random.Random, spread: bool = False, interpod: bool = False) -> dict:
    spec: dict = {
        "containers": [
            {
                "name": "c",
                "resources": {
                    "requests": {
                        "cpu": f"{rng.choice([100, 250, 500, 1000])}m",
                        "memory": f"{rng.choice([128, 256, 512, 1024])}Mi",
                    }
                },
            }
        ]
    }
    labels = {"app": f"app-{i % 8}", "tier": "web" if i % 2 else "db"}
    if i % 4 == 0:
        spec["nodeSelector"] = {"disk": "ssd"}
    if spread:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": 3,
                "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": f"app-{i % 8}"}},
            },
            {
                "maxSkew": 5,
                "topologyKey": "kubernetes.io/hostname",
                "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": f"app-{i % 8}"}},
            },
        ]
    if interpod and (aff := _interpod_affinity(i)):
        spec["affinity"] = aff
    return {"metadata": {"name": f"pod-{i}", "namespace": "default", "labels": labels}, "spec": spec}


IMAGES = [(f"registry.example/app-{k}:v1", (k + 1) * 150 * 1024 * 1024) for k in range(6)]


def cluster(n_pods: int, n_nodes: int, seed: int = 42, n_bound: int = 0, spread=False, interpod=False):
    """(nodes, all_pods, pending) of a seeded cluster in queue order.

    Beyond the bench shapes, drawn from the same seed: NoSchedule taints
    on every 8th node with tolerations on every 3rd pod, node 3
    unschedulable (every 10th pod tolerates it), pod 5 pinned to
    ``node-7`` by nodeName, and container images on nodes and pods
    (ImageLocality).  ``n_bound`` pods
    are bound round-robin before the round, so the carry starts non-empty.
    ``spread`` and ``interpod`` are predicates on the pod index (bound pods
    first), or False: the pods they pick carry the spread constraints and
    the inter-pod terms of ``mk_pod``.
    """
    rng = random.Random(seed)
    nodes = [mk_node(i) for i in range(n_nodes)]
    pods = [
        mk_pod(i, rng, spread=bool(spread and spread(i)), interpod=bool(interpod and interpod(i)))
        for i in range(n_pods + n_bound)
    ]
    for i, n in enumerate(nodes):
        if i % 8 == 3:
            n["spec"] = {
                "taints": [{"key": "dedicated", "value": f"team-{i % 3}", "effect": "NoSchedule"}]
                + n["spec"].get("taints", [])
            }
        n["status"]["images"] = [
            {"names": [nm], "sizeBytes": sz} for nm, sz in IMAGES if rng.random() < 0.4
        ]
    if n_nodes > 3:
        nodes[3]["spec"]["unschedulable"] = True
    for i, p in enumerate(pods):
        spec = p["spec"]
        spec["containers"][0]["image"] = IMAGES[rng.randrange(len(IMAGES))][0]
        if i % 3 == 0:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Equal", "value": f"team-{i % 3}", "effect": "NoSchedule"}]
        if i % 10 == 0:
            spec.setdefault("tolerations", []).append(
                {"key": "node.kubernetes.io/unschedulable", "operator": "Exists", "effect": "NoSchedule"}
            )
    if n_pods > 5 and n_nodes > 7:
        pods[n_bound + 5]["spec"]["nodeName"] = "node-7"
    for j, p in enumerate(pods[:n_bound]):
        p["spec"]["nodeName"] = f"node-{j % n_nodes}"
    return nodes, pods, pods[n_bound:]


def add_host_ports(pods: list) -> None:
    """DaemonSet-style host ports, by pod index (bound pods first): pods
    with ``i % 25 == 11`` take hostPort 8080/TCP, pods with ``i % 40 == 17``
    443/TCP (disjoint sets)."""
    for i, p in enumerate(pods):
        port = 8080 if i % 25 == 11 else 443 if i % 40 == 17 else None
        if port is not None:
            p["spec"]["containers"][0]["ports"] = [{"containerPort": port, "hostPort": port, "protocol": "TCP"}]


# the object shapes of the JAX package's volume tests
CSI_DRIVER = "csi.example.com"


def mk_pv(name: str, labels=None, node_affinity=None, csi_driver=None) -> dict:
    pv: dict = {
        "metadata": {"name": name, "labels": labels or {}},
        "spec": {"capacity": {"storage": "10Gi"}, "accessModes": ["ReadWriteOnce"]},
    }
    if node_affinity is not None:
        pv["spec"]["nodeAffinity"] = {"required": node_affinity}
    if csi_driver:
        pv["spec"]["csi"] = {"driver": csi_driver, "volumeHandle": name}
    return pv


def mk_pvc(name: str, ns: str = "default", volume_name=None, storage_class=None, access="ReadWriteOnce") -> dict:
    pvc: dict = {
        "metadata": {"name": name, "namespace": ns},
        "spec": {"accessModes": [access], "resources": {"requests": {"storage": "1Gi"}}},
    }
    if volume_name:
        pvc["spec"]["volumeName"] = volume_name
    if storage_class:
        pvc["spec"]["storageClassName"] = storage_class
    return pvc


def mk_sc(name: str, binding_mode: str = "Immediate", provisioner: str = CSI_DRIVER) -> dict:
    return {"metadata": {"name": name}, "provisioner": provisioner, "volumeBindingMode": binding_mode}


def mk_csinode(node_name: str, driver: str, count: int) -> dict:
    return {"metadata": {"name": node_name}, "spec": {"drivers": [{"name": driver, "allocatable": {"count": count}}]}}


def pvc_volume(claim: str, vol_name: str = "v") -> dict:
    return {"name": vol_name, "persistentVolumeClaim": {"claimName": claim}}


def add_volumes(nodes: list, pods: list, n_bound: int = 0) -> dict:
    """Give a ``cluster`` snapshot (``pods`` = all pods, bound ones first)
    volumes by pod index, and return its volume objects:

    - every 10th pod (``i % 10 == 1``) mounts a claim of its own bound to a
      CSI PV of ``csi.example.com``, alternately one with a zone label
      (VolumeZone) and one with node affinity on ``disk=ssd``
      (VolumeBinding code 2);
    - ``i % 20 == 7`` mounts an unbound WaitForFirstConsumer claim;
    - ``i % 40 == 23`` mounts one of 16 shared ReadWriteMany CSI claims;
    - ``i % 50 == 9`` a read-write GCE PD ``pd-{i % 40}``, ``i % 100 == 5``
      an EBS volume ``vol-{i % 30}``, ``i % 200 == 15`` an Azure disk
      ``az-{i % 16}`` (VolumeRestrictions and the cloud limits);
    - every node has a CSINode allowing 24 volumes of the driver, every
      16th node only 1, and the bound pod on such a node
      holds a CSI volume of its own (NodeVolumeLimits rejects it for a pod
      bringing a new one).
    """
    vols: dict = {"persistentvolumeclaims": [], "persistentvolumes": [], "storageclasses": [], "csinodes": []}
    vols["storageclasses"] += [mk_sc("standard"), mk_sc("wfc", binding_mode="WaitForFirstConsumer")]
    vols["persistentvolumeclaims"] += [
        mk_pvc(f"shared-{k}", volume_name=f"pv-shared-{k}", access="ReadWriteMany") for k in range(16)
    ]
    vols["persistentvolumes"] += [mk_pv(f"pv-shared-{k}", csi_driver=CSI_DRIVER) for k in range(16)]
    ssd = {"nodeSelectorTerms": [{"matchExpressions": [{"key": "disk", "operator": "In", "values": ["ssd"]}]}]}

    def own_claim(i: int, k: int) -> dict:
        name = f"data-{i}"
        zone = {"topology.kubernetes.io/zone": f"zone-{k % 8}"}
        vols["persistentvolumes"].append(
            mk_pv(f"pv-{name}", labels=zone if k % 2 == 0 else None, node_affinity=None if k % 2 == 0 else ssd,
                  csi_driver=CSI_DRIVER)
        )
        vols["persistentvolumeclaims"].append(mk_pvc(name, volume_name=f"pv-{name}", storage_class="standard"))
        return pvc_volume(name)

    full_nodes = {j % len(nodes) for j in range(n_bound) if (j % len(nodes)) % 16 == 0}
    for i, p in enumerate(pods):
        v: list = []
        if i % 10 == 1:
            v.append(own_claim(i, i // 10))
        elif i < n_bound and i % len(nodes) in full_nodes:
            full_nodes.discard(i % len(nodes))
            v.append(own_claim(i, i // 10))
        if i % 20 == 7:
            vols["persistentvolumeclaims"].append(mk_pvc(f"wfc-{i}", storage_class="wfc"))
            v.append(pvc_volume(f"wfc-{i}"))
        if i % 40 == 23:
            v.append(pvc_volume(f"shared-{i % 16}"))
        if i % 50 == 9:
            v.append({"name": "pd", "gcePersistentDisk": {"pdName": f"pd-{i % 40}"}})
        if i % 100 == 5:
            v.append({"name": "ebs", "awsElasticBlockStore": {"volumeID": f"vol-{i % 30}"}})
        if i % 200 == 15:
            v.append({"name": "az", "azureDisk": {"diskName": f"az-{i % 16}", "diskURI": f"uri/az-{i % 16}"}})
        for k, vol in enumerate(v):
            vol["name"] = f"{vol['name']}-{k}"
        if v:
            p["spec"]["volumes"] = v
    vols["csinodes"] = [
        mk_csinode(n["metadata"]["name"], CSI_DRIVER, 1 if j % 16 == 0 else 24) for j, n in enumerate(nodes)
    ]
    return vols


def stamp(pod: dict, i: int) -> dict:
    """A creationTimestamp derived from ``i`` (the bench's deterministic
    stamps): PrioritySort breaks ties on it, so runs of the same shape are
    byte-comparable."""
    pod["metadata"]["creationTimestamp"] = f"2024-03-01T{i // 3600 % 24:02d}:{i // 60 % 60:02d}:{i % 60:02d}Z"
    return pod


def churn(store, n_pods: int, n_nodes: int, waves: int, delete_frac: float = 0.1, cordon: int = 0, seed: int = 7):
    """BASELINE cfg5's scenario churn (the JAX package's bench ``run_churn``
    with deterministic stamps) driven into ``store``, a generator: it
    creates ``n_nodes`` nodes, then per wave creates ``n_pods // waves``
    pods (bench's ``mk_pod``, spread constraints on every 3rd) and yields
    the wave index, for the caller to schedule; after each wave it deletes
    ``delete_frac`` of the bound pods, drawn by a ``random.Random(seed)``.

    ``cordon`` > 0 adds a rolling cordon, as a node-pool upgrade drains
    nodes a few at a time: before every wave after the first,
    ``spec.unschedulable`` is set on ``cordon`` nodes (drawn by the same
    generator from the nodes not cordoned) and cleared on the ones
    cordoned before the previous wave, by store patches."""
    rng = random.Random(seed)
    for i in range(n_nodes):
        store.create("nodes", mk_node(i))
    per_wave = n_pods // waves
    created = 0
    cordoned: list = []
    for w in range(waves):
        if cordon and w > 0:
            fresh = rng.sample(sorted(set(range(n_nodes)) - set(cordoned)), cordon)
            for i in cordoned:
                store.patch("nodes", f"node-{i}", {"spec": {"unschedulable": None}})
            for i in fresh:
                store.patch("nodes", f"node-{i}", {"spec": {"unschedulable": True}})
            cordoned = fresh
        for _ in range(per_wave):
            store.create("pods", stamp(mk_pod(created, rng, spread=created % 3 == 0), created))
            created += 1
        yield w
        bound = [p for p in store.list("pods") if (p.get("spec") or {}).get("nodeName")]
        for p in rng.sample(bound, int(len(bound) * delete_frac)):
            store.delete("pods", p["metadata"]["name"], p["metadata"].get("namespace"))


# cfg9-stream (the JAX package's bench ``run_stream_report``): 600 nodes, a
# standing population of 6 000 bound pods, 100 arrivals and 100 deletions of
# settled pods a tick, 320 timed ticks after one priming tick
STREAM = dict(n_nodes=600, seed_bound=6000, per_tick=100, ticks=320)


def stream_cluster(store, n_nodes: int = 600, seed_bound: int = 6000) -> "collections.deque":
    """cfg9-stream's standing cluster (bench ``run_stream_report``'s
    ``build``) created in ``store``: ``n_nodes`` bench nodes and
    ``seed_bound`` bench pods (``random.Random(7)``, spread constraints on
    every 3rd) bound round-robin; returns the settled pod names, oldest
    first, for ``steady_feed`` to delete from."""
    rng = random.Random(7)
    for i in range(n_nodes):
        store.create("nodes", mk_node(i))
    settled: collections.deque = collections.deque()
    for i in range(seed_bound):
        p = stamp(mk_pod(1_000_000 + i, rng, spread=i % 3 == 0), i)
        p["metadata"]["name"] = f"seed-{i}"
        p["spec"]["nodeName"] = f"node-{i % n_nodes}"
        store.create("pods", p)
        settled.append(f"seed-{i}")
    return settled


def steady_feed(store, settled, n_ticks: int, start: int, per_tick: int = 100, seed_bound: int = 6000):
    """cfg9-stream's arrival stream (bench ``steady_feed``): a feed for
    ``schedule_stream`` (or a caller's own tick loop) of ``n_ticks`` ticks,
    each creating ``per_tick`` bench pods (``random.Random(11 + start)``,
    names from ``pod-{start}``, spread constraints on every 3rd) and
    deleting ``per_tick`` of the oldest settled pods, keeping the last two
    ticks' arrivals (a streamed feed runs one commit ahead of the round
    loop, so only pods every mode has committed are deleted)."""
    rng = random.Random(11 + start)
    state = {"created": start}

    def feed(tick: int) -> bool:
        if tick >= n_ticks:
            return False
        fresh = []
        for _ in range(per_tick):
            i = state["created"]
            state["created"] += 1
            store.create("pods", stamp(mk_pod(i, rng, spread=i % 3 == 0), seed_bound + i))
            fresh.append(f"pod-{i}")
        for _ in range(min(per_tick, max(0, len(settled) - 2 * per_tick))):
            nm = settled.popleft()
            try:
                store.delete("pods", nm, "default")
            except KeyError:
                pass
        settled.extend(fresh)
        return True

    return feed


def preemption_wave(
    store, n_nodes: int = 5000, n_low: int = 20000, n_fillers: int = 400, n_preemptors: int = 64,
    n_pdbs: int = 16, seed: int = 7,
) -> dict:
    """cfg7-preempt-5k: Kubernetes scheduler_perf's ``PreemptionBasic``
    (test/integration/scheduler_perf/config/performance-config.yaml:
    node-default.yaml, pod-low-priority.yaml, pod-high-priority.yaml) at its
    5000Nodes cluster size, created in ``store``; returns the names of the
    pods by role.

    - ``n_nodes`` nodes of 4 CPU, 32Gi and 110 pods allocatable;
    - ``n_low`` bound low-priority pods, spread evenly (4 a node at the
      default sizes), each 900m CPU and 500Mi, with seeded priorities from
      {0, 1, 2}, seeded ``startTime``s (a minute's 3 600 distinct stamps, so
      ties occur) and labels ``app=a{k}``, k from 0 to 63;
    - ``n_pdbs`` PodDisruptionBudgets on ``app`` a0, a1, ... each allowing
      2 disruptions (16 cover a quarter of the victims);
    - pending: ``n_fillers`` fillers of 100m and 100Mi at priority 50, then
      ``n_preemptors`` preemptors of 3 CPU and 500Mi at priority 10, every
      8th pinned by ``nodeSelector`` to a hostname of its own.  The fillers
      outrank the preemptors, so the preemptors ride the queue's tail.

    Departures from scheduler_perf, which bring the victim search's PDB,
    tie-break and same-window paths onto the path: the victim priorities,
    the PDBs and the fillers.  The pinned preemptors' nodes hold only
    priority-2 victims, so pickOneNodeForPreemption ranks them last for the
    unpinned preemptors and each pinned preemptor finds its node as the
    round started."""
    rng = random.Random(seed)
    for i in range(n_nodes):
        alloc = {"cpu": "4", "memory": "32Gi", "pods": "110"}
        store.create("nodes", {
            "metadata": {"name": f"node-{i}", "labels": {"kubernetes.io/hostname": f"node-{i}"}},
            "spec": {},
            "status": {"allocatable": dict(alloc), "capacity": dict(alloc)},
        })
    pinned_nodes = rng.sample(range(n_nodes), len(range(0, n_preemptors, 8)))
    pinned = set(pinned_nodes)

    def pod(name: str, i: int, cpu: str, mem: str, prio: int, labels=None) -> dict:
        p = {
            "metadata": {"name": name, "namespace": "default", "labels": labels or {}},
            "spec": {
                "priority": prio,
                "containers": [{"name": "c", "resources": {"requests": {"cpu": cpu, "memory": mem}}}],
            },
        }
        return stamp(p, i)

    names: dict = {"low": [], "fillers": [], "preemptors": []}
    for j in range(n_low):
        node = j * n_nodes // n_low
        prio = 2 if node in pinned else rng.choice([0, 1, 2])
        p = pod(f"low-{j}", j, "900m", "500Mi", prio, {"app": f"a{rng.randrange(64)}"})
        p["spec"]["nodeName"] = f"node-{node}"
        p["status"] = {"phase": "Running", "startTime": f"2024-02-01T00:{rng.randrange(60):02d}:{rng.randrange(60):02d}Z"}
        store.create("pods", p)
        names["low"].append(p["metadata"]["name"])
    for k in range(n_pdbs):
        store.create("poddisruptionbudgets", {
            "metadata": {"name": f"pdb-a{k}", "namespace": "default"},
            "spec": {"selector": {"matchLabels": {"app": f"a{k}"}}},
            "status": {"disruptionsAllowed": 2},
        })
    for i in range(n_fillers):
        store.create("pods", pod(f"filler-{i}", n_low + i, "100m", "100Mi", 50))
        names["fillers"].append(f"filler-{i}")
    for i in range(n_preemptors):
        p = pod(f"preemptor-{i}", n_low + n_fillers + i, "3", "500Mi", 10)
        if i % 8 == 0:
            p["spec"]["nodeSelector"] = {"kubernetes.io/hostname": f"node-{pinned_nodes[i // 8]}"}
        store.create("pods", p)
        names["preemptors"].append(p["metadata"]["name"])
    return names


def gang_churn(
    store, jobs: int = 200, min_members: int = 8, max_members: int = 64, nodes: int = 220, waves: int = 5,
    seed: int = 24, node=mk_node,
):
    """cfg8-gang as the JAX package's bench drives it (``run_gang``), a
    generator: it creates the default namespace and ``nodes`` nodes
    (``node(i)``, bench's ``mk_node`` by default: 64 CPU, 256Gi, 512 pods,
    8 zones), draws the plan of ``jobs`` jobs of ``min_members`` to
    ``max_members`` members from ``random.Random(seed)``, then per wave
    creates that wave's jobs (a PodGroup with minMember = its member count
    and a 600 s timeout, and the members: gang/scenario ``make_member``, 1
    CPU and 1Gi) and yields the wave index, for the caller to schedule;
    after each wave the previous wave's jobs complete (members and group
    deleted).  The defaults are cfg8-gang's scale leg (plan seed 24); its
    parity leg is ``jobs=24, min_members=2, max_members=8, nodes=40,
    seed=23``."""
    from kube_scheduler_simulator_tpu_torch.gang.scenario import make_member

    rng = random.Random(seed)
    plan = [rng.randint(min_members, max_members) for _ in range(jobs)]
    store.create("namespaces", {"metadata": {"name": "default"}})
    for i in range(nodes):
        store.create("nodes", node(i))
    per_wave = max(len(plan) // waves, 1)
    prev: list = []
    for w in range(waves):
        batch = plan[w * per_wave : (w + 1) * per_wave] if w < waves - 1 else plan[(waves - 1) * per_wave :]
        cur = []
        for j, members in enumerate(batch):
            g = f"job-{w}-{j}"
            store.create("podgroups", {"metadata": {"name": g}, "spec": {"minMember": members, "scheduleTimeoutSeconds": 600}})
            for m in range(members):
                store.create("pods", make_member(f"{g}-m{m}", g))
            cur.append((g, members))
        yield w
        for g, members in prev:
            for m in range(members):
                try:
                    store.delete("pods", f"{g}-m{m}")
                except KeyError:
                    pass
            store.delete("podgroups", g)
        prev = cur


# cfg6-autoscale's node groups (the JAX package's bench ``run_autoscale``):
# (name, cpu, memory, disk label)
AUTOSCALE_GROUPS = (
    ("pool-small", "8000m", "32Gi", "ssd"),
    ("pool-mid", "16000m", "64Gi", "hdd"),
    ("pool-big", "64000m", "256Gi", "ssd"),
)


def node_group(name: str, cpu: str, memory: str, labels: dict, max_size: int, taints=None) -> dict:
    """A NodeGroup at minSize 0 whose template has ``labels`` plus a zone of
    its own, 110 pods and, when given, ``taints``."""
    template: dict = {
        "metadata": {"labels": {**labels, "topology.kubernetes.io/zone": f"zone-{name}"}},
        "status": {"allocatable": {"cpu": cpu, "memory": memory, "pods": "110"}},
    }
    if taints:
        template["spec"] = {"taints": taints}
    return {"metadata": {"name": name}, "spec": {"minSize": 0, "maxSize": max_size, "template": template}}


def autoscale(store, start, n_pods: int = 1500, seed_nodes: int = 4, max_size: int = 48, seed: int = 11):
    """cfg6-autoscale as the JAX package's bench ``run_autoscale`` builds it
    in ``store``: ``seed_nodes`` bench nodes and the three node groups of
    ``AUTOSCALE_GROUPS`` at maxSize ``max_size``, then ``start(store)`` (the
    caller builds and starts its scheduler service there, as the bench
    does before the pods arrive), then ``n_pods`` pending pods of bench's
    ``mk_pod`` drawn from ``random.Random(seed)``.  Returns what ``start``
    returned."""
    rng = random.Random(seed)
    for i in range(seed_nodes):
        store.create("nodes", mk_node(i))
    for name, cpu, mem, disk in AUTOSCALE_GROUPS:
        store.create("nodegroups", node_group(name, cpu, mem, {"disk": disk}, max_size))
    svc = start(store)
    for i in range(n_pods):
        store.create("pods", mk_pod(i, rng))
    return svc


def autoscale_burst(n_groups: int = 16, copies: int = 64, n_pending: int = 10_000, seed: int = 11):
    """(groups, headroom, pending) of one scale-up estimate against many
    pools: ``n_groups`` node groups, group g of 4(g + 1) CPU and 4 GiB a CPU
    (4 to 64 CPU at 16 groups), ``disk`` ssd on odd groups and hdd on even
    ones, every 4th group tainted ``NoSchedule`` (no pending pod tolerates
    it); ``copies`` template copies each (the reference autoscaler's
    ``max_nodes_per_scale_up``); ``n_pending`` pods of bench's ``mk_pod``
    drawn from ``random.Random(seed)``."""
    rng = random.Random(seed)
    groups = []
    for g in range(n_groups):
        cpu = 4 * (g + 1)
        taints = [{"key": "dedicated", "value": "batch", "effect": "NoSchedule"}] if g % 4 == 3 else None
        groups.append(node_group(f"burst-{g:02d}", str(cpu), f"{4 * cpu}Gi", {"disk": "ssd" if g % 2 else "hdd"},
                                 copies, taints))
    headroom = {gr["metadata"]["name"]: copies for gr in groups}
    return groups, headroom, [mk_pod(i, rng) for i in range(n_pending)]


# cfg10-tune-10k: the JAX bench's tune report (bench.py:1094
# run_tune_report, its 8 pods a node, bench.py:1108-1111) at north's 10 000
# pods; the report's rows as (family, tuner)
TUNE = dict(n_nodes=1250, n_pods=10_000, seed=11, steps=8, pop=16, tau=50.0, lr=1.0)
TUNE_ROWS = (("imbalance", "cem"), ("consolidate", "cem"), ("imbalance", "grad"))


def tune(family: str = "imbalance", n_nodes: int = 1250, n_pods: int = 10_000, seed: int = 11):
    """(nodes, pods, objective name) of a tuner scenario family
    (``tuning.scenario.build_family``): cfg10-tune-10k at the defaults."""
    from kube_scheduler_simulator_tpu_torch.tuning.scenario import build_family

    return build_family(family, n_nodes=n_nodes, n_pods=n_pods, seed=seed)
