"""Scheduler gym: batched PyTorch training environments, the REINFORCE
trainer that replaces RLDS constructor pre-training, and the policy zoo.

    from repro_torch.gym import (PolicyZoo, default_stages,
                                 save_rlds_params, train_rlds)

    params, logs = train_rlds(default_stages("full", num_devices=(64, 256)))
    zoo = PolicyZoo("policies")
    save_rlds_params(zoo, "rlds-full", params, num_jobs=3)
    # then: ExperimentSpec(..., scheduler="rlds", policy="rlds-full")

Every entry point runs on ``device="cuda"`` unless the caller passes
another device. Shell entry point: ``python -m repro_torch.gym
train|eval|list``.
"""

from repro_torch.gym.env import (
    EnvConfig,
    EnvState,
    StepOut,
    Transition,
    batch_reset,
    batch_rollout,
    config_from_cost_model,
    greedy_plan,
    policy_rollout,
    reset,
    sample_plan,
    state_from_pool,
    step,
)
from repro_torch.gym.scenarios import CURRICULA, ScenarioSpec
from repro_torch.gym.train import (
    TrainConfig,
    default_stages,
    evaluate,
    train_rlds,
)
from repro_torch.gym.zoo import DEFAULT_ZOO_DIR, PolicyZoo, save_rlds_params

__all__ = [
    "CURRICULA",
    "DEFAULT_ZOO_DIR",
    "EnvConfig",
    "EnvState",
    "PolicyZoo",
    "ScenarioSpec",
    "StepOut",
    "TrainConfig",
    "Transition",
    "batch_reset",
    "batch_rollout",
    "config_from_cost_model",
    "default_stages",
    "evaluate",
    "greedy_plan",
    "policy_rollout",
    "reset",
    "sample_plan",
    "save_rlds_params",
    "state_from_pool",
    "step",
    "train_rlds",
]
