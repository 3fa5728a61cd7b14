"""The data service (the port's own copy of the matching part of
``petastorm_tpu/service/``): a :class:`Dispatcher` owns the split plan,
:class:`BatchWorker` s serve collated numpy batches over framed TCP, and a
:class:`ServiceBatchSource` feeds them to a trainer's ``TorchDataLoader``;
the seed tree (:mod:`~petastorm_tpu_torch.service.seedtree`) orders pieces
deterministically. The control plane: the dispatcher's journal
(:mod:`~petastorm_tpu_torch.service.journal`), fencing resyncs, and the
resilience layer's breakers, retry budgets, hedging and brownout
(:mod:`~petastorm_tpu_torch.service.resilience`). The fleet
(:mod:`~petastorm_tpu_torch.service.fleet`): jobs with fair shares
(:func:`register_job`, :func:`end_job`, :class:`JobHandle`), standby
workers and the autoscaler; the fleet cache tier
(:mod:`~petastorm_tpu_torch.cache_impl.fleet_tier`); the chaos harness
(:mod:`~petastorm_tpu_torch.service.chaos`). The LLM stages: worker- or
trainer-placed sequence packing (:class:`PackingSpec`,
:class:`StreamPacker`, :class:`PackedBatchSource`) and multi-corpus
mixtures with journaled weight changes (:class:`MixtureSampler`,
:class:`MixedBatchSource`, :func:`set_mixture_weights`). Run a node with
``python -m petastorm_tpu_torch.service dispatcher|worker``."""

from petastorm_tpu_torch.service.chaos import ChaosInjector
from petastorm_tpu_torch.service.client import ServiceBatchSource, ServiceError
from petastorm_tpu_torch.service.dispatcher import Dispatcher
from petastorm_tpu_torch.service.fleet import (
    AutoscaleConfig,
    AutoscalePlanner,
    JobHandle,
    end_job,
    plan_fair_shares,
    register_job,
)
from petastorm_tpu_torch.service.journal import Journal
from petastorm_tpu_torch.service.mixture import (
    MixedBatchSource,
    MixtureSampler,
    MixtureSpec,
    get_mixture_weights,
    set_mixture_weights,
)
from petastorm_tpu_torch.service.packing_stage import (
    PackedBatchSource,
    PackingSpec,
    StreamPacker,
)
from petastorm_tpu_torch.service.worker import BatchWorker

__all__ = ["BatchWorker", "Dispatcher", "ServiceBatchSource", "ServiceError", "Journal",
           "ChaosInjector", "AutoscaleConfig", "AutoscalePlanner", "JobHandle",
           "register_job", "end_job", "plan_fair_shares", "MixedBatchSource",
           "MixtureSampler", "MixtureSpec", "set_mixture_weights", "get_mixture_weights",
           "PackedBatchSource", "PackingSpec", "StreamPacker"]
