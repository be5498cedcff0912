"""The control plane's, the meshes', the training path's, the RWKV
block's, the topology's and the sharding rules' public surface against
the reference's: every public class, method and function of the ported
modules has the reference's parameter names, order, kinds and defaults
(a dtype default by its name).  The only differences are listed in
``EXCEPTIONS`` (the port's entry points take a ``device``, its random
draws a ``torch.Generator``, its collectives a process group, its job
placement the service that solves it) and ``NOT_PORTED`` (with the
ROADMAP step that ports them)."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import repro.serve
import repro_torch.serve
from repro.core import batch_sharded as ref_batch_sharded
from repro.core import distributed as ref_distributed
from repro.launch import mesh as ref_mesh
from repro.launch import elastic as ref_elastic
from repro.launch import placement as ref_placement
from repro.launch import train as ref_launch_train
from repro.models import api as ref_api
from repro.models import rwkv as ref_rwkv
from repro.parallel import collectives as ref_collectives
from repro.parallel import sharding as ref_sharding
from repro.serve import cluster as ref_cluster
from repro.serve import fleet as ref_fleet
from repro.serve import rm as ref_rm
from repro.serve import trace as ref_trace
from repro.serve import transport as ref_transport
from repro.topology import hlocost as ref_hlocost
from repro.topology import tpu as ref_tpu
from repro.topology import traffic as ref_traffic
from repro.train import checkpoint as ref_checkpoint
from repro.train import data as ref_data
from repro.train import optimizer as ref_optimizer
from repro.train import step as ref_step
from repro_torch.core import batch_sharded, distributed
from repro_torch.launch import elastic, mesh, placement
from repro_torch.launch import train as launch_train
from repro_torch.models import api, rwkv
from repro_torch.parallel import collectives, sharding
from repro_torch.topology import hlocost, tpu, traffic
from repro_torch.serve import cluster, fleet, rm, trace, transport
from repro_torch.train import checkpoint, data, optimizer, step

MODULES = {
    "core.batch_sharded": (ref_batch_sharded, batch_sharded),
    "core.distributed": (ref_distributed, distributed),
    "launch.mesh": (ref_mesh, mesh),
    "serve.cluster": (ref_cluster, cluster),
    "serve.transport": (ref_transport, transport),
    "serve.fleet": (ref_fleet, fleet),
    "serve.rm": (ref_rm, rm),
    "serve.trace": (ref_trace, trace),
    "launch.placement": (ref_placement, placement),
    "models.api": (ref_api, api),
    "models.rwkv": (ref_rwkv, rwkv),
    "train.data": (ref_data, data),
    "train.optimizer": (ref_optimizer, optimizer),
    "train.step": (ref_step, step),
    "train.checkpoint": (ref_checkpoint, checkpoint),
    "launch.train": (ref_launch_train, launch_train),
    "launch.elastic": (ref_elastic, elastic),
    "parallel.collectives": (ref_collectives, collectives),
    "parallel.sharding": (ref_sharding, sharding),
    "topology.traffic": (ref_traffic, traffic),
    "topology.hlocost": (ref_hlocost, hlocost),
    "topology.tpu": (ref_tpu, tpu),
}

# qualified name -> (parameters the port drops, parameters it adds)
EXCEPTIONS = {
    "launch.placement.PlacementService.__init__": (set(), {"device"}),
    "launch.mesh.make_local_mesh": (set(), {"device"}),
    "launch.mesh.make_instance_mesh": (set(), {"device"}),
    "models.api.Model.__init__": (set(), {"device"}),
    "models.api.Model.init": ({"key"}, {"generator", "seed"}),
    "models.api.make_concrete_batch": ({"key"}, {"generator"}),
    "models.rwkv.rwkv_make_cache": (set(), {"device"}),
    "train.checkpoint.CheckpointManager.restore": ({"shardings"}, {"device"}),
    "launch.train.train": (set(), {"device"}),
    "parallel.collectives.compressed_allreduce_mean": ({"axis"}, {"group"}),
    "launch.placement.place_job": (set(), {"service"}),
}

# Reference names the port does not have, each with the ROADMAP step
# that ports it.
NOT_PORTED = {
    # no step: JAX's shard_map across its versions; the port's ranks are
    # processes that run the solver bodies themselves
    "core.distributed": {"shard_map"},
}


def _own(module):
    """Public functions and classes defined in ``module`` itself."""
    return {name: obj for name, obj in vars(module).items()
            if not name.startswith("_") and getattr(obj, "__module__", None)
            == module.__name__ and (inspect.isfunction(obj)
                                    or inspect.isclass(obj))}


def _members(cls):
    """A class's own public methods, properties, class- and static
    methods, plus ``__init__``."""
    out = {}
    for name, obj in vars(cls).items():
        if name.startswith("_") and name != "__init__":
            continue
        if isinstance(obj, (staticmethod, classmethod)):
            out[name] = obj.__func__
        elif isinstance(obj, property):
            out[name] = obj.fget
        elif inspect.isfunction(obj):
            out[name] = obj
    return out


def _default(value):
    if value is inspect.Parameter.empty:
        return value
    if isinstance(value, torch.dtype):
        return ("dtype", str(value).split(".")[-1])
    if isinstance(value, type) and isinstance(getattr(value, "dtype", None),
                                              np.dtype):
        return ("dtype", value.dtype.name)      # jnp.float32 and the like
    if callable(value) and hasattr(value, "__name__"):
        return ("callable", value.__name__)
    return value


def _params(fn):
    return [(p.name, p.kind, _default(p.default))
            for p in inspect.signature(fn).parameters.values()]


def _surface():
    cases = []
    for mod_name, (ref_mod, port_mod) in sorted(MODULES.items()):
        for name, ref_obj in sorted(_own(ref_mod).items()):
            if name in NOT_PORTED.get(mod_name, ()):
                continue
            qual = f"{mod_name}.{name}"
            if inspect.isfunction(ref_obj):
                cases.append((qual, ref_obj, getattr(port_mod, name, None)))
                continue
            port_cls = getattr(port_mod, name, None)
            for member, fn in sorted(_members(ref_obj).items()):
                if member in NOT_PORTED.get(qual, ()):
                    continue
                port_fn = None if port_cls is None else \
                    _members(port_cls).get(member)
                cases.append((f"{qual}.{member}", fn, port_fn))
    return cases


CASES = _surface()


@pytest.mark.parametrize("qual,ref_fn,port_fn", CASES,
                         ids=[c[0] for c in CASES])
def test_signature_matches_reference(qual, ref_fn, port_fn):
    assert port_fn is not None, f"{qual} is missing from the port"
    want, got = _params(ref_fn), _params(port_fn)
    dropped, added = EXCEPTIONS.get(qual, (set(), set()))
    want = [p for p in want if p[0] not in dropped]
    got = [p for p in got if p[0] not in added]
    assert got == want
    assert {p[0] for p in _params(port_fn)} & dropped == set()


@pytest.mark.parametrize("mod_name", sorted(MODULES))
def test_every_public_name_is_ported(mod_name):
    ref_mod, port_mod = MODULES[mod_name]
    missing = set(_own(ref_mod)) - set(_own(port_mod)) \
        - NOT_PORTED.get(mod_name, set())
    assert not missing


@pytest.mark.parametrize("cls_name", ["Allocation", "Candidate", "FaultPlan",
                                      "FleetStats", "JobSpec", "RMStats",
                                      "ReplayReport", "PlacementResult",
                                      "CollectiveOp", "HloCost",
                                      "Instruction", "Computation",
                                      "PodSpec"])
def test_dataclass_fields_match_reference(cls_name):
    mods = [(ref_cluster, cluster), (ref_fleet, fleet), (ref_rm, rm),
            (ref_placement, placement), (ref_traffic, traffic),
            (ref_hlocost, hlocost), (ref_tpu, tpu)]
    ref_cls, port_cls = next((getattr(r, cls_name), getattr(p, cls_name))
                             for r, p in mods if hasattr(r, cls_name))
    fields = lambda c: [(f.name, _default(f.default), f.kw_only)
                        for f in dataclasses.fields(c)]
    assert fields(port_cls) == fields(ref_cls)
    assert port_cls.__dataclass_params__.frozen == \
        ref_cls.__dataclass_params__.frozen


def test_serve_exports_every_reference_name():
    assert set(repro.serve.__all__) <= set(repro_torch.serve.__all__)
    for name in repro_torch.serve.__all__:
        assert hasattr(repro_torch.serve, name), name
    assert {"EngineStats", "Engine", "ServeConfig"} <= \
        set(repro_torch.serve.__all__)


def test_module_constants_match_reference():
    assert fleet.TRANSPORTS == ref_fleet.TRANSPORTS
    assert fleet.DEFAULT_SUBPROCESS_HEARTBEAT_TIMEOUT_S == \
        ref_fleet.DEFAULT_SUBPROCESS_HEARTBEAT_TIMEOUT_S
    assert fleet.DEFAULT_SUBPROCESS_COMPILING_GRACE_S == \
        ref_fleet.DEFAULT_SUBPROCESS_COMPILING_GRACE_S
    assert transport.DEFAULT_HEARTBEAT_INTERVAL_S == \
        ref_transport.DEFAULT_HEARTBEAT_INTERVAL_S
    assert rm.DEFAULT_POLICIES == ref_rm.DEFAULT_POLICIES
    assert (rm.PENDING, rm.QUEUED, rm.RUNNING, rm.FINISHED) == \
        (ref_rm.PENDING, ref_rm.QUEUED, ref_rm.RUNNING, ref_rm.FINISHED)
    assert rm.RMJournal.VERSION == ref_rm.RMJournal.VERSION
    assert trace.SWF_FIELDS == ref_trace.SWF_FIELDS
    assert rm.JobHandle.__slots__ == ref_rm.JobHandle.__slots__
