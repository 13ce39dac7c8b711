from repro_torch.core.codecs import (CODECS, Codec, DenseRefCodec,
                                     IdentityCodec, PackedBitstreamCodec,
                                     ThresholdGraphCodec, resolve_codec)
from repro_torch.fl.engine import (SCHEDULERS, BatchedEngine, ChannelMeter,
                                   CohortTrainer, DeviceRegistry, FLEngine,
                                   SerialTrainer)
from repro_torch.fl.fleet import (ASSIGNERS, FleetConfig, MultiTaskEngine,
                                  build_fleet)
from repro_torch.fl.policies import (POLICIES, CodecPolicy, DispatchContext,
                                     make_policy)
from repro_torch.fl.protocols import (METHODS, STRATEGIES, ProtocolStrategy,
                                      best_acc_within, make_setup, make_sim,
                                      make_strategy, profile_compression,
                                      run_method, time_to_acc)
from repro_torch.fl.simulator import (FLSimulator, LogEntry, ScenarioConfig,
                                      SimConfig, TierSpec)
from repro_torch.fl.tasks import TASKS, FLTask, get_task, register_task

__all__ = [
    "CODECS", "Codec", "DenseRefCodec", "IdentityCodec",
    "PackedBitstreamCodec", "ThresholdGraphCodec", "resolve_codec",
    "SCHEDULERS", "BatchedEngine", "ChannelMeter", "CohortTrainer",
    "DeviceRegistry", "FLEngine", "SerialTrainer",
    "ASSIGNERS", "FleetConfig", "MultiTaskEngine", "build_fleet",
    "POLICIES", "CodecPolicy", "DispatchContext", "make_policy",
    "METHODS", "STRATEGIES", "ProtocolStrategy", "best_acc_within",
    "make_setup", "make_sim", "make_strategy", "profile_compression",
    "run_method", "time_to_acc",
    "FLSimulator", "LogEntry", "ScenarioConfig", "SimConfig", "TierSpec",
    "TASKS", "FLTask", "get_task", "register_task",
]
