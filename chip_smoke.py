#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device       — require CUDA; print the card's name and power limit.
2. build        — build every kernel from the sources in the checkout
                  (one nvcc per source, all started together).
3. kernels      — the flash forward (B1) against its plain PyTorch version
                  on the card at the shapes the serving path gives it,
                  then timed beside its plain version, its roofline bound
                  and one library call.
4. bwd kernels  — the flash backward kernels (B2 dq, B3 dkv) against their
                  plain versions at the same shapes; B1, B2 and B3 held
                  against their plain versions at the training shape
                  [16, 1024, 12, 64] bf16 causal, then timed there beside
                  their plain versions, bounds and the library's attention;
                  then the host's cost of a launch: the wall clock of 200
                  back-to-back calls of each wrapper at [1, 64, 12, 64],
                  bf16 (which encodes TMA tensor maps) and f32 (which
                  does not), beside the kernels' device time there.
   llama kernels — B1, B2 and B3 at Llama-1B's attention (head dim 128, k
                  and v of 8 KV heads repeated to 16): held against their
                  plain versions at the training path's [4, 4096, 16, 128]
                  bf16 causal (B1's O row by row, with a planted fault to
                  show the check's power), then timed there beside their
                  plain versions, bounds and the library's attention.
5. parity       — GPT-2 small at full width in float32: the engine's greedy
                  tokens equal the full-forward generate_greedy oracle's.
6. serve        — the serving path: GPT-2 small in bfloat16 serving 16
                  concurrent requests through LLMEngine; every request ends
                  with its max_tokens, no KV block leaks, and the flash
                  kernel launched n_layer times per prefill.
7. profile      — the same traffic under torch.profiler (device busy share,
                  time by kernel) and one T=1024 prefill timed alone.
8. train parity — one float32 AdamW step of GPT-2 small at full width
                  (B=2, T=128) on the card (kernels) and on the CPU (plain
                  versions) from the same weights: loss, every gradient,
                  every parameter after the step.
9. train        — the training path (bench.py's configuration): GPT-2 small,
                  float32 params with bfloat16 compute, B=16, T=1024, AdamW
                  lr 3e-4; 3 warm-up and 10 timed steps with a finite,
                  falling loss and B1 = B2 = B3 = n_layer launches a step;
                  one remat step (B1 twice a layer, the same loss); step
                  time, tokens/s, MFU, and the device's idle share and time
                  by kernel under torch.profiler.
10. llama parity — one float32 AdamW step at Llama-1B's full width and 2
                  of its layers (B=1, T=256) on the card and on the CPU.
11. llama train — the main path of the model families: Llama-1B at full
                  width and depth, f32 params, bf16 compute, remat, B=4,
                  T=4096, AdamW; 3 warm-up and 10 timed steps with a
                  finite, falling loss and B1 32, B2 16, B3 16 launches a
                  step; step time, tokens/s, MFU, peak memory, and one
                  step under torch.profiler.
12. resnet      — one float32 SGD-momentum step at resnet18's widths card
                  vs CPU (loss, gradients, parameters, new running
                  statistics); ResNet-50 at bench_resnet.py's configuration
                  (bf16, B=512, 32x32, SGD 0.1 momentum 0.9), 13 steps.
13. vit, mlp    — each at its default config: an f32 AdamW step card vs
                  CPU, then 13 bf16 steps with a falling loss.
14. moe         — MoEMLP at its default widths in float32: output, aux loss
                  and gradients, card vs CPU; then the same weights placed
                  by moe_sharding_rules() on a one-card {"ep": 1} mesh
                  (the stacked experts Shard(0) over ep): output and aux
                  loss equal to the unsharded card's bit for bit.
15. runtime     — the port's actor runtime and trainer on the card:
                  ray_tpu_torch.init(num_cpus=4) reads GPU 1.0 from the
                  node's device files, and GPU-<type> 1.0 and
                  GPU-<type>-head 1.0 with the type <family>-1 from the
                  card's name (phase 25 (a): a clean process that imports
                  no torch detects 1 card of that type and maps no
                  /dev/nvidia-uvm), and no runtime process but the
                  worker holds a CUDA context; (a) a num_gpus=1 actor takes
                  phase 8's f32 GPT-2 small step and returns its loss (a
                  CPU tensor, through the object store) and its launches,
                  equal to the driver's to 1e-4 relative and (12, 12, 12);
                  (b) GPT-2 small at bench.py's configuration trains inside
                  TorchTrainer.fit() on one GPU worker, phase 9's 3 warm-up
                  steps and then 60 timed ones, B1 = B2 = B3 = n_layer
                  launches a step counted inside the worker, the first 13
                  losses equal to phase 9's raw run to 1e-5 relative; while
                  it steps, a thread of the driver finds the worker through
                  util.state.list_actors and takes util.state.profile(worker,
                  duration_s=2, mode="cpu"): complete, samples > 0, a share
                  in gpt2_loop's frames, the record in state.profiles(); its
                  top 10 frames, its window against the timed steps, and the
                  step time under it beside phase 9's raw step are printed;
                  (c) the cluster's head runs the Ray Client server
                  (ray_client_server_port): a subprocess that imports no
                  torch connects with init("ray://..."), builds an
                  ActorPool of two num_gpus=0.5 actors, each GPT-2 small f32
                  on the card from one seed, and maps 8 batches of [4, 512]
                  prompts: last-position logits and greedy ids (numpy) equal
                  this process's card forward bit for bit in submission
                  order, map_unordered the same set, B1 12 x 8 launches
                  (each call's count put on a util.queue.Queue the client
                  drains), no libtorch or libcuda in the client's maps, the
                  pool's tasks in state.timeline(), and after it disconnects
                  its actors DEAD and GPU 1.0 free; shutdown() leaves no
                  port process (the client server included).
16. serve plane — the serve control plane on the card on the routers'
                  actor-RPC path (serve_channel_dataplane off for its
                  cluster, and the replica's dataplane serves nothing),
                  under its own ray_tpu_torch.init(num_cpus=4): serve.run of
                  llm.build_app(cfg), whose replica leases GPU 1.0 for its
                  engine on the card, behind the HTTP proxy (the counting
                  servers below keep build_app's deployment and swap its
                  class).  (a) phase 6's
                  16-request mix in float32 as 16 concurrent chunked HTTP
                  streams: every request's greedy tokens equal this
                  process's LLMEngine's on the same card; one StaticBatchLLMServer
                  batch of 4 mixed-length prompts over HTTP, one lane
                  decoding past max_seq_len, equal to this process's
                  static server, with n_layer B1 launches in its replica; (b)
                  phase 6's bf16 mix over HTTP: every request ends at its
                  max_tokens, B1 launched n_layer x 16 times in the
                  replica, zero KV blocks and sequences left, every token
                  equal to phase 6's, client-side TTFT and decode rate
                  beside phase 6's; (c) the controller
                  and the proxy map neither libcuda nor libtorch, the
                  replica maps libcuda; (d) serve.shutdown() and
                  shutdown() leave no port process.
17. dataplane   — phase 16's traffic and checks again under a cluster of
                  its own with the default configuration, so the routers
                  reach the replicas over the channel dataplane (ring
                  channels, tokens streamed back as frames): phase 16's
                  f32 references, the static batch, and four of the f32
                  requests through the gRPC proxy (serve.start(grpc_port=
                  ...)) equal this process's engine; the bf16 mix as in
                  phase 16, and the replica's dataplane served all 16
                  streams and every stream item (no request fell back to
                  RPC); the controller and both proxies map neither
                  libcuda nor libtorch.  Beside the bf16 mix,
                  util.state.profile(replica, duration_s=1.5, mode="cpu"):
                  complete, a share in the engine's step loop, its top 10
                  frames printed; then one streamed bf16 request with a
                  traceparent, sent through the proxy's own handle in the
                  proxy's process (its HTTP handler reads no such header):
                  state.traces() holds one connected trace over the driver,
                  the proxy and the replica, its critical path segments and
                  state.dataplane()'s per-hop queue waits (p50, p95)
                  printed.  Then a compiled DAG: Prefill (a
                  num_gpus=1 actor, GPT-2 small f32 on its card, the
                  attention through B1) returns the last position's
                  logits [4, vocab] as a CUDA tensor, Argmax (a CPU actor)
                  the greedy ids, MultiOutputNode([logits, ids]); 8
                  executions of [4, 1000] prompts through execute_many
                  equal this process's forward exactly, reach it as CPU
                  f32 tensors, launch B1 12 x 8 times in Prefill, leave
                  Argmax without a CUDA context and no ring directory
                  after teardown().  serve.shutdown() and shutdown()
                  leave no port process and no ring directory.  B1 is
                  then held against its plain version and timed at the
                  static batch's prefill shape.
18. data        — Ray Data and the device collective group under a
                  cluster of its own: eight .npy token shards [64, 1025]
                  int32 from a seed, read by read_numpy and dealt by
                  TorchTrainer's streaming_split to one GPU worker, where
                  gpt2_loop takes each batch from iter_device_batches
                  (pinned host buffers, a copy stream, two batches ahead)
                  and trains GPT-2 medium at the reference's defaults
                  (f32 params, bf16 compute, remat), B=16, T=1024, AdamW
                  as phase 9, 3 warm-up and 10 timed steps.  Every batch
                  reaches the step as a CUDA int64 tensor with the rows
                  Data's own iter_batches gives in the driver (distinct
                  rows of the shards); every loss equals the driver's raw
                  run on the same rows and seed to 1e-5 relative; B1 2 x
                  24, B2 and B3 24 launches a step, counted in the worker;
                  a finite, falling loss; no port process but the training
                  worker maps libtorch or libcuda; shutdown() leaves no
                  port process.  Step time, tokens/s, MFU, peak memory
                  and the wait in next() are printed.  A num_gpus=1 actor
                  forms a world-size-1 "nccl" collective group: allreduce,
                  broadcast and allgather of f32 and bf16 CUDA tensors come
                  back on the card bit for bit, a numpy array through the
                  host ring, a generation bump re-forms the group and a
                  call on the old one raises GroupInvalidatedError.  Then
                  B1, B2 and B3 at GPT-2 medium's [16, 1024, 16, 64] bf16
                  causal, held against their plain versions and timed.
19. sharded     — the sharded planes: phase 18's GPT-2 medium, shards,
                  rows and seed under TorchTrainer(sharding_config=
                  ShardingConfig(mesh_shape={"batch": -1, "model": 1}))
                  on one GPU worker: gpt2_loop calls plan_from_context(),
                  shard_init and jit_train_step on a one-card DeviceMesh
                  and takes each batch from iter_device_batches(sharding=
                  plan.data_sharding()).  Every parameter and AdamW moment
                  is a DTensor with the rule table's placements; B1 2 x 24,
                  B2 and B3 24 launches a step in the worker; every loss
                  equals phase 18's raw run to 1e-5 relative; each batch a
                  DTensor on the card in Data's order; then the checkpoint
                  drill on GPT-2 medium's widths at 2 layers (the same
                  rows and seed): an unbroken run of 13 steps, a replay of
                  steps 1 to 6 on a second model and a sharded checkpoint
                  at step 6 (plan.save_checkpoint) loaded into a fresh plan
                  give steps 1 to 13 equal to the unbroken run's to 1e-6;
                  no port process after shutdown().  Then ring attention's
                  per-block path for 4 ranks emulated on the card at
                  [16, 1024, 16, 64] bf16: each non-causal B1/B2/B3 launch
                  on a [16, 256, 16, 64] block held against its plain
                  version (with a planted fault), the merged O and the
                  gradients against B1-B3 causal over the whole T; then the
                  three non-causal at the ring block, timed.
20. pipeline    — the pipeline planes, under a cluster of their own: (a)
                  GPT-2 medium's widths at 2 layers in f32, B=16 as 4
                  microbatches, T=1024, PipelinePlane(stages=2) with both
                  stage actors on the card: 3 steps, each loss equal to an
                  unpipelined f32 step's in the driver from the same
                  weights and rows to 1e-4 relative; the kill drill (stage
                  1 killed after step 3, a checkpoint every 2 steps, one
                  restart) lands within 2e-5 of an unbroken run's losses;
                  (b) the slice's main path: GPT-2 medium (24 layers, f32
                  params, bf16 compute) from phase 18's weights and rows,
                  8 steps of PipelinePlane.run over two stage actors that
                  lease half the card each, 1F1B through B1, B2 and B3,
                  activations and gradients over ring channels: launches
                  (96, 48, 48) a step in stage 0 (its B recomputes the
                  forward) and (48, 48, 48) in stage 1, 0 in the driver;
                  finite, falling losses, step 1's equal to phase 18's raw
                  first loss to 1e-3 relative and the rest within
                  PP_LOSS_TOL of the raw run's; step time, tokens/s, MFU,
                  each stage's busy time, bubble and peak memory; no ring
                  directory after stop(), no port process after
                  shutdown(); (c) B1, B2, B3 at the microbatch's [4, 1024,
                  16, 64] bf16 causal held against their plain versions
                  and timed; (d) the SPMD pipeline at GPT-2 medium's
                  widths (8 layers, f32, B=4, T=1024): make_pp_loss_fn at
                  pp=4, M=4 and make_pp_loss_fn_interleaved at pp=4, v=2,
                  M=4 emulated on the card, and make_pp_loss_fn on a
                  one-card {"pp": 1} mesh, against the unpipelined loss
                  (1e-4 relative) and gradients (1e-3 of each tensor's
                  max).
21. tune and rllib — Tune and RLlib under a cluster of their own: (a)
                  Tuner(TorchTrainer(gpt2 loop)) over phase 9's GPT-2
                  small batch and seed, lr in {1e-4, 3e-4, 1e-3}, 4 steps
                  a trial, max_concurrent_trials=1, ASHA on the reported
                  loss: each trial's fit() runs in its trial actor and its
                  worker leases the card; B1 = B2 = B3 = n_layer launches
                  a step counted in each trial's worker, the driver's 0;
                  the 3e-4 trial's losses equal phase 9's direct run to
                  1e-5 relative; the ResultGrid names the lowest-loss
                  trial; each trial's start-up split into [timing] lines
                  (the trial actor, the worker's start to its loop, its
                  CUDA context, the process group, the model's init, the
                  steps, the report, the teardown) from the cluster's
                  actor table and the loop's stamps; (b) where gymnasium is installed, PPO on
                  CartPole-v1 under Tuner(tune.with_resources(PPO, {"cpu":
                  1, "gpu": 1})) at tests/test_rllib.py's configuration:
                  episode_return_mean past 120 within 30 iterations, the
                  learner on cuda in the trial actor (which maps libcuda)
                  and the env runners on their CPUs (which make no
                  CUDA context; importing torch maps libcuda there),
                  env-steps/s and the learner's update time an iteration,
                  the trial's checkpoint restoring its weights (without
                  gymnasium (b) is not run and its absence printed);
                  shutdown() leaves no port process; (c) PPO's learner
                  with the Nature-CNN torso on 84 x 84 x 4 uint8 frames,
                  1024 rows, minibatch 128, 2 epochs: one
                  update_from_batch_epochs in f32 on the card against the
                  same update on the CPU (its first Adam step by phase
                  8's rule; over the 16 steps every minibatch's loss to
                  5e-3 relative, beside the CPU's own spread), then timed
                  on the card.  The podracer plane at the Nature-CNN's
                  widths, f32, card vs CPU from the same weights, each
                  held as (c) and then timed: (d) IMPALA's
                  update_from_fragments, 8 updates of one [50, 8]
                  fragment (400 frames, a termination and its autoreset
                  row); (e) APPO's update_from_batch of 4 such fragments
                  flattened env by env (its target policy synced after
                  updates 2 and 4); (f) PPO's prepare_fragments (to 1e-5)
                  and update_from_fragments of 4 fragments, minibatch
                  128, 2 epochs; inside the cluster, (g) the sebulba
                  InferenceServer as an actor with its module on the card
                  (one CPU, no GPU lease): 4 CPU actors x 16 concurrent
                  greedy calls of [8, 84, 84, 4] uint8, every answer at
                  generation 3, actions equal to the driver's CPU module,
                  values to 1e-4, libcuda in the server and not in the
                  callers; (h) where gymnasium is installed, IMPALA with
                  .podracer() on CartPole-v1, the learner on cuda, over
                  ring channels (without gymnasium its absence is
                  printed); no ring directory left after shutdown().
22. rllib rest  — the rest of RLlib in f32, card vs CPU from the same
                  weights and noise, each held as 21 (c) to (f) (the first
                  update's metrics to 1e-4 relative or twice the CPU's own
                  spread for weights moved 1e-6, each optimizer's first
                  step by phase 8's rule, every loss to 5e-3 beside that
                  spread) and then timed on the card: under a cluster of
                  its own, (c) 1024 seeded transitions written as parquet
                  through the port's Data and as JSONL through JsonWriter
                  read back through OfflineData, row for row, and (d)
                  PPO with multi_agent() of two explicit RLModuleSpecs on
                  a plain-Python two-agent env, two CPU runner actors (no
                  CUDA context), a learner group a policy on cuda: one
                  train() reports both policies, a checkpoint restores
                  both policies' weights, no port process left after
                  shutdown(); then (a) DQNLearner at its defaults on
                  CartPole's shapes, batch 32, 8 updates from a
                  PrioritizedReplayBuffer (TD errors 1e-4 of max, the
                  target synced after update 4); (b) SACLearner at (256,
                  256) on Pendulum's shapes, batch 256, 4 updates (alpha,
                  the Polyak step, the state's round trip); (c) BC's and
                  MARWIL's train() with the learner on cuda, CQLLearner's
                  update in its BC phase and after it, IS and WIS from a
                  module on the card (1e-5); (e) DreamerV3Learner at its
                  defaults (deter 128, 8 x 8, 16 x 16 sequences, horizon
                  10), one update held (its world-model terms 1e-4), 8
                  timed.
23. operator    — the operator's surface: ``ray-tpu-torch start --head
                  --num-cpus 4 --num-gpus 0`` in a subprocess (cli status
                  shows GPU 0; the head's dashboard answers /api/version,
                  /api/nodes and /api/cluster_status); in this process a
                  StandardAutoscaler over FakeMultiNodeProvider (one node
                  type, gpu_worker {"CPU": 2, "GPU": 1}, max_workers 1)
                  under a Monitor; a job submitted through
                  JobSubmissionClient with a runtime_env whose driver (no
                  torch, no libcuda) runs a workflow: a num_gpus=1 step
                  runs (c)'s batch 0 of phase 15 through GPT-2 small f32
                  on the card, a CPU step takes the argmax.  Held: one
                  gpu_worker launched; the job SUCCEEDED; the logits and
                  ids equal phase 15 (c)'s forward bit for bit; 12 B1
                  launches in the step; the runtime_env's variable seen
                  there; workflow.resume returns the same output and the
                  task events hold one GPU step; the idle node drained
                  and terminated, GPU back to 0 in cluster_resources()
                  and the dashboard; ``cli stop`` leaves no port process.
24. preemption  — (a) a cluster_utils.Cluster of a head {"num_cpus": 1,
                  "num_gpus": 0} and two nodes {"num_cpus": 2, "num_gpus":
                  1} (both count the one card); TorchTrainer with one GPU
                  worker runs gpt2_loop's drain-aware option at phase 9's
                  configuration for 8 steps, FailureConfig(max_failures=0):
                  a periodic checkpoint at step 3 (the step, the weights and
                  AdamW's state), a driver thread drains the rank's node
                  (PREEMPTION, deadline 60 s) once step 5 is reported, the
                  loop checkpoints at the notice and the trainer restarts
                  the rank on the other node from it.  Held: one drain,
                  result step 8, resumed_from >= 5, the resumed steps on the
                  other node, every step's loss equal to phase 9's of that
                  step to 1e-5 relative, B1 = B2 = B3 = 12 launches a step
                  in each worker, the GPU free again after the drained node
                  is killed, no port process after shutdown(); printed: the
                  notice to the written checkpoint, its bytes, the notice to
                  the first resumed step.  (b) beside (a), from a driver
                  process of its own (no torch): a GCS spawned alone and one
                  raylet {"CPU": 2, "GPU": 1}; a num_gpus=1 actor holds
                  GPT-2 small f32 from phase 15 (c)'s seed and answers its
                  batch 0; the GCS is killed, the actor answers during the
                  outage, a new function's first call blocks until a new
                  GCS on the same session directory is up, the actor
                  answers again.  Held: the three answers' logits and ids
                  equal phase 15 (c)'s forward bit for bit, 12 B1 launches
                  each, one actor pid, ALIVE in the new GCS, the GPU free
                  after the actor, no port process left; printed: the
                  outage and the restart to the blocked call's return.

25. gpu slice   — inside phase 23's CLI head (before its shutdown), an
                  AutoscalerV2 over GPUNodeProvider with MockGpuClient
                  and launch_local_raylets, one node type of slice type
                  h100-1 ({"CPU": 4, "GPU": 1, "GPU-h100-1-head": 1});
                  a task asking for {"GPU-h100-1-head": 1, "GPU": 1}
                  runs phase 23's GPT-2 small f32 step on the slice's
                  node.  Held: one slice launched, the step on that node
                  (not the head), its logits and ids equal phase 15 (c)'s
                  forward bit for bit, 12 B1 launches; the slice idles
                  out: deleted from the mock API, terminated, GPU and the
                  slice's resources gone from cluster_resources();
                  printed: the times of launch, ready, first result and
                  termination.  Phase 23's [timing] line includes this
                  phase's; the script's summary keeps them apart.

Every phase's seconds are printed ([timing]) as it ends, and all of them
with the script's total before the result lines.  The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import copy
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import serve as rt_serve
from ray_tpu_torch.models import gpt2, llama, mlp, moe, resnet, vit
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.serve import llm as rt_llm
from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine, LLMServer, StaticBatchLLMServer
from ray_tpu_torch.serve.llm.engine import FINISHED
from ray_tpu_torch.train import RunConfig, ScalingConfig
from ray_tpu_torch.train.torch import TorchTrainer
from ray_tpu_torch.train.torch.gpt2_loop import model_config, train_loop_per_worker

# H100 SXM published peaks (NVIDIA data sheet; dense bf16 tensor cores,
# HBM3), the denominators of every bound below
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores: B1's f32 route
PEAK_BYTES = 3.35e12

KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
PROMPT_VOCAB = 50257  # GPT-2's tokenizer; the model's 50304 rows pad it
PARITY_LENS = (5, 37, 130, 300)
# the serving path's 16 prompts: every prefill bucket from 8 to 1024
SERVE_LENS = (5, 12, 30, 60, 100, 200, 300, 400, 520, 600, 700, 800, 900, 960, 20, 45)
# the training path: bench.py's GPT-2 small configuration
TRAIN_B, TRAIN_T, TRAIN_LR = 16, 1024, 3e-4
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# kernel-vs-plain cases, (T, dtype, causal, D, fused q/k/v): the prefill
# buckets' range with ragged 100, both dtypes, one non-causal case and
# D=128 per dtype; then bf16 on both sides of the first and second TMA
# tile edges (64-row tiles in B1's K/V ring, in B2 and B3 at D=64 and in
# the rings of B2 and B3 at D=128; 128-row blocks over two warpgroups in
# B1 at both head dims and in B2 and B3 at D=128)
_DTYPES = (torch.bfloat16, torch.float32)
EDGE_TS = (1, 63, 65, 127, 129, 255, 257, 1000)
KERNEL_CASES = ([(T, dt, True, 64, True) for T in (8, 100, 256, 1024) for dt in _DTYPES]
                + [(100, dt, False, 64, False) for dt in _DTYPES]
                + [(256, dt, True, 128, False) for dt in _DTYPES]
                + [(T, torch.bfloat16, True, 64, True) for T in EDGE_TS]
                + [(T, torch.bfloat16, False, 128, True) for T in EDGE_TS]
                + [(T, torch.bfloat16, True, 128, True) for T in (129, 257)])


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA card")
    card = _card()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    # float32 means float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_all(KERNEL_SOURCES)
    print(f"[build] {len(KERNEL_SOURCES)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in KERNEL_SOURCES:
        secs, log = _build.build_info[name]
        print(f"[build] {name}: nvcc {secs:.2f} s", flush=True)
        # ptxas -v: each kernel's name, registers and spills, and any
        # "Potential Performance Loss" (C75xx: wgmma serialised)
        for line in log.splitlines():
            if any(w in line.lower() for w in ("entry function", "registers", "spill", "error",
                                               "warning", "performance loss")):
                print(f"[build]   {line.strip()}", flush=True)


def _qkv(T: int, H: int, D: int, dtype: torch.dtype, fused: bool, seed: int, B: int = 1):
    """q, k, v [B, T, H, D] on the card: views of one fused [B, T, 3*H*D]
    projection (the serving path's layout) or three contiguous tensors."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused:
        qkv = torch.randn(B, T, 3 * H * D, generator=g, device="cuda").to(dtype)
        return tuple(t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    return tuple(torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype) for _ in range(3))


def _time_ms(fn, reps: int = 20, rounds: int = 7, sleep_cycles: int = 2_000_000) -> float:
    """Median per-call device time over ``rounds`` runs of ``reps`` calls,
    CUDA events around each run; a device-side sleep of ``sleep_cycles``
    before each run lets the host queue the calls ahead, so launch
    overhead is not timed (as long as the sleep outlasts the host's
    enqueueing of the run)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_kernels(card: str) -> dict:
    """The flash forward against its plain version; returns its record
    (launches are filled in by the serving phase)."""
    # f32: both sides compute in f32 and differ only in summation order.
    # bf16: the kernel rounds P to bf16 before P.V (relative 2^-9 per
    # probability) where the plain version keeps f32, and both round O
    # once to bf16: 2e-2 covers one bf16 ulp for |O| in [2, 4) plus the P
    # rounding.  The LSE is f32 on both sides.
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
    main_err = None
    for i, (T, dt, causal, D, fused) in enumerate(KERNEL_CASES):
        q, k, v = _qkv(T, 12, D, dt, fused, seed=i)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
        if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"non-finite kernel output at T={T} {dt} causal={causal} D={D}")
        e_o = (out.float() - ref_out.float()).abs().max().item()
        e_l = (lse - ref_lse).abs().max().item()
        o_tol, l_tol = tol[dt]
        ok = e_o <= o_tol and e_l <= l_tol
        print(f"[kernels] flash_fwd T={T:5d} {str(dt)[6:]:8s} causal={int(causal)} D={D:3d} "
              f"{'fused' if fused else 'contig'}: max|dO|={e_o:.3e} (tol {o_tol:g}) "
              f"max|dLSE|={e_l:.3e} (tol {l_tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version at T={T} {dt}")
        if (T, dt, causal, D) == (1024, torch.bfloat16, True, 64):
            main_err = (e_o, e_l)

    # timing at the largest prefill of the main path: B=1, T=1024, H=12,
    # D=64, bf16, q/k/v as views of the fused projection.  A call's device
    # time (about 15 us) is below its host time (35 to 55 us, the [host]
    # lines of phase_host_cost), so the device sleeps 25 ms before each run
    # of 20 calls: at 1 ms the host's enqueueing outlasts the sleep and the
    # time read is the host's
    B, T, H, D = 1, 1024, 12, 64
    q, k, v = _qkv(T, H, D, torch.bfloat16, True, seed=99)
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v), sleep_cycles=50_000_000)
    plain_ms = _time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v), reps=5, rounds=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), sleep_cycles=50_000_000)
    rec = _record("flash_attention_fwd", "serve", (B, T, H, D), ms, plain_ms, library_ms,
                  *_fwd_work(B, T, H, D), main_err[0], max_abs_err_lse=main_err[1])
    _print_record("kernels", rec, card)
    return rec


# the kernels' sources and the TPU kernels they replace
_SOURCES = {
    "flash_attention_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                            "ray_tpu/ops/pallas_attention.py:54"),
    "flash_attention_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                           "ray_tpu/ops/pallas_attention.py:136"),
    "flash_attention_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                            "ray_tpu/ops/pallas_attention.py:172"),
}


def _pairs(T: int, causal: bool = True) -> int:
    """The (query, key) pairs the kernels compute: the causal triangle, or
    every pair."""
    return T * (T + 1) // 2 if causal else T * T


def _fwd_work(B, T, H, D, elt=2, causal=True):
    """(FLOPs, bytes) of B1: QK^T and PV over the pairs; q, k, v read once,
    O and the f32 LSE written once."""
    return 4 * B * H * D * _pairs(T, causal), 4 * B * T * H * D * elt + B * H * T * 4


def _dq_work(B, T, H, D, elt=2, causal=True, with_delta=False):
    """B2: QK^T, dO V^T and dS K; q, k, v, dO, LSE, Delta in, dQ out.  With
    Delta formed in B2 (``with_delta``), also rowsum(dO * O): O in and
    Delta out instead of in."""
    flops = 6 * B * H * D * _pairs(T, causal) + (2 * B * T * H * D if with_delta else 0)
    return flops, (5 + with_delta) * B * T * H * D * elt + 2 * B * H * T * 4


def _dkv_work(B, T, H, D, elt=2, causal=True):
    """B3: K Q^T, V dO^T, P^T dO and dS^T Q; the same inputs, dK and dV out."""
    return 8 * B * H * D * _pairs(T, causal), 6 * B * T * H * D * elt + 2 * B * H * T * 4


def _record(name, path, shape, ms, plain_ms, library_ms, flops, bytes_moved, err,
            dtype: str = "bfloat16", causal: bool = True, **extra):
    """One kernel's entry of the JSON line; launches are filled in by the
    phase that drives its path.  bf16 runs on the tensor cores, f32 on
    the CUDA cores: each is bounded by its own peak."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS) * 1e3
    source, replaces = _SOURCES[name]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "path": path,
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "at": "[B, T, H, D] = [%d, %d, %d, %d] %s %s" % (
            *shape, dtype, "causal" if causal else "non-causal"),
        "gflop": flops / 1e9,
        "mb": bytes_moved / 1e6,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        **extra,
    }


def _print_record(tag: str, rec: dict, card: str) -> None:
    print(f"[{tag}] {rec['name']} @ {rec['at']}: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {rec['gflop']:.3f} GFLOP, "
          f"{rec['mb']:.3f} MB), {rec['achieved_tflops']:.2f} TFLOP/s — {card}", flush=True)


def _rel(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, that over max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


def phase_bwd_kernels(card: str) -> list:
    """The backward kernels against their plain versions, then B1, B2 and
    B3 timed at the training shape; returns their records."""
    # Relative to max |ref| of each gradient (their scale varies with T and
    # the inputs).  f32: both sides compute in f32 in another summation
    # order.  bf16: the kernels round P and dS to bf16 before their products
    # (2^-9 relative per entry) where the plain version keeps f32, and both
    # round each output once to bf16 (2^-8 relative at most): 1e-2.  At T=1
    # the softmax over one key is constant, so dQ and dK are zero but for
    # rounding: there they are measured against the largest dV entry.
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    for i, (T, dt, causal, D, fused) in enumerate(KERNEL_CASES):
        q, k, v = _qkv(T, 12, D, dt, fused, seed=100 + i)
        do = _qkv(T, 12, D, dt, False, seed=200 + i)[0]
        o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
        errs = []
        for j, (a, b) in enumerate(zip(got, ref)):
            err = (a.float() - b.float()).abs().max().item()
            norm = ref[2] if T == 1 and j < 2 else b
            errs.append((err, err / norm.float().abs().max().item()))
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        ok = finite and all(rel <= tol[dt] for _, rel in errs)
        print(f"[bwd kernels] T={T:5d} {str(dt)[6:]:8s} causal={int(causal)} D={D:3d} "
              f"{'fused' if fused else 'contig'}: max|err|/max|ref| dq {errs[0][1]:.3e} "
              f"dk {errs[1][1]:.3e} dv {errs[2][1]:.3e} (tol {tol[dt]:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash backward disagrees with its plain version at T={T} {dt}")

    # the training shape: q/k/v views of the fused projection, dO
    # contiguous (as autograd hands it over), O and LSE from B1
    B, T, H, D = TRAIN_B, TRAIN_T, 12, 64
    g = torch.Generator(device="cuda").manual_seed(300)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
    errs = _hold_bf16_kernels("bwd kernels", "training shape", "fused", q, k, v, do)
    return _time_bf16_kernels("bwd kernels", "train", q, k, v, do, errs, card)


def _row_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows (all but the last dim) of max |got - ref| over that
    row's max |ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()


# B1's O held row by row: each row of O is a convex mix of V's rows, whose
# size falls as 1/sqrt(keys) along a causal T (late rows' entries are ~0.02
# at T=4096), so an absolute limit that covers the early rows' rounding
# hides a fault in the late ones.  Both sides round O once to bf16 (one ulp
# is at most 2^-7 of the row's largest entry) after the kernel's P rounding
# (2^-9 relative per probability, averaging out over the keys): 2e-2 of
# each row's largest entry
O_ROW_TOL = 2e-2


def _hold_bf16_kernels(tag: str, label: str, layout: str, q, k, v, do) -> dict:
    """B1, B2 and B3 in bf16 causal on these inputs against their plain
    versions: B1 at phase_kernels' bf16 tolerances (2e-2 on O, 1e-3 on the
    LSE) and O at O_ROW_TOL of each row's largest entry, B2/B3 at
    phase_bwd_kernels' 1e-2 of each gradient's largest entry.  The row
    check's power is shown on a planted fault: the plain version with one
    64-key V tile zeroed (keys T-128..T-65), which leaves the LSE exact and
    moves only the last 128 rows, must read above O_ROW_TOL.  The Delta
    that B2 forms in its prologue is held against the torch ``_delta`` to
    1e-5 of max |Delta| (both sum dO * O in f32, in another order).  Raises
    on a disagreement, else returns the errors that the records carry."""
    shape = tuple(q.shape)
    o, lse = fa.flash_attention_fwd(q, k, v)
    ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v)
    fwd_err = (o.float() - ref_o.float()).abs().max().item()
    row_err = _row_rel(o, ref_o)
    lse_err = (lse - ref_lse).abs().max().item()
    v_fault = v.clone()
    v_fault[:, -128:-64] = 0
    fault_err = _row_rel(fa.flash_attention_fwd_reference(q, k, v_fault)[0], ref_o)
    del ref_o, ref_lse, v_fault
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    delta = fa.flash_attention_dq(q, k, v, do, lse, o=o)[1]
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    errs = dict(zip(("dq", "dk", "dv"), (_rel(a, b) for a, b in zip(got, ref))))
    errs["delta"] = _rel(delta, fa._delta(o, do))
    finite = all(bool(torch.isfinite(a.float()).all()) for a in (o, lse, delta, *got))
    del got, ref, delta
    ok = (finite and fwd_err <= 2e-2 and row_err <= O_ROW_TOL and lse_err <= 1e-3
          and errs["delta"][1] <= 1e-5
          and all(errs[x][1] <= 1e-2 for x in ("dq", "dk", "dv")))
    print(f"[{tag}] {label} {shape} bfloat16 causal {layout}: flash_fwd "
          f"max|dO|={fwd_err:.3e} (tol 0.02), by row {row_err:.3e} of max|O_ref| (tol "
          f"{O_ROW_TOL:g}; one V tile zeroed reads {fault_err:.3e}) max|dLSE|={lse_err:.3e} "
          f"(tol 0.001); max|err|/max|ref| dq {errs['dq'][1]:.3e} dk {errs['dk'][1]:.3e} dv "
          f"{errs['dv'][1]:.3e} (tol 0.01), B2's Delta {errs['delta'][1]:.3e} (tol 1e-05) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"flash kernels disagree with their plain versions at the "
                             f"{label} {shape}")
    if fault_err <= O_ROW_TOL:
        raise AssertionError(f"B1's row check at the {label} {shape} cannot see a zeroed "
                             f"V tile ({fault_err:.3e} <= {O_ROW_TOL:g})")
    return {"fwd": fwd_err, "fwd_row": row_err, "fwd_fault_row": fault_err, "lse": lse_err,
            **errs}


def _time_bf16_kernels(tag: str, path: str, q, k, v, do, errs: dict, card: str,
                       plain_reps: int = 3, causal: bool = True,
                       sleep_cycles: int = 2_000_000, delta_in_dq: bool = True) -> list:
    """B1, B2 and B3 timed on these inputs beside their plain versions,
    their bounds and the library's attention on the same q, k, v
    (``scaled_dot_product_attention``'s forward for B1, its backward for
    B2 and B3); returns the three records with ``errs`` from
    ``_hold_bf16_kernels`` (or the ring's hold).  B2 is timed as its path
    calls it: forming Delta in its prologue (``delta_in_dq``, the
    backward's path; its plain version then includes ``_delta``) or
    reading a given Delta (ring attention's blocks); the other way is
    timed beside it, as is the torch Delta that the backward no longer
    runs.  ``sleep_cycles`` is ``_time_ms``'s: a small shape needs a
    longer sleep, or the library's backward (an autograd call,
    host-heavy) times its host."""
    time_ms = functools.partial(_time_ms, sleep_cycles=sleep_cycles)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = fa.flash_attention_dq(q, k, v, do, lse, causal=causal, o=o)[1]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    shape = tuple(q.shape)
    fwd_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal))
    fwd_plain = time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v, causal),
                         reps=plain_reps, rounds=3)
    with torch.no_grad():
        fwd_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
    dq_with_delta_ms = time_ms(lambda: fa.flash_attention_dq(q, k, v, do, lse, causal=causal,
                                                             o=o))
    dq_given_delta_ms = time_ms(lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, causal))
    dq_ms = dq_with_delta_ms if delta_in_dq else dq_given_delta_ms
    dq_plain = time_ms(lambda: fa.flash_attention_dq_reference(
        q, k, v, do, lse, fa._delta(o, do) if delta_in_dq else delta, causal),
        reps=plain_reps, rounds=3)
    dkv_ms = time_ms(lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta, causal))
    dkv_plain = time_ms(
        lambda: fa.flash_attention_dkv_reference(q, k, v, do, lse, delta, causal),
        reps=plain_reps, rounds=3)
    bwd_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal))
    torch_delta_ms = time_ms(lambda: fa._delta(o, do))
    # the library computes dq, dk and dv in one backward call
    bwd_lib = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                                   retain_graph=True))
    lib_note = {"library_call": "scaled_dot_product_attention backward: dq, dk and dv in "
                                "one call", "flash_attention_bwd_ms": bwd_ms}
    dq_note = {"dq_with_delta_ms": dq_with_delta_ms, "dq_given_delta_ms": dq_given_delta_ms,
               "torch_delta_ms": torch_delta_ms, "delta_in_dq": delta_in_dq}
    if "delta" in errs:
        dq_note.update(max_abs_err_delta=errs["delta"][0], max_rel_err_delta=errs["delta"][1])
    recs = [
        _record("flash_attention_fwd", path, shape, fwd_ms, fwd_plain, fwd_lib,
                *_fwd_work(*shape, causal=causal), errs["fwd"], causal=causal,
                max_abs_err_lse=errs["lse"], max_row_rel_err=errs["fwd_row"],
                planted_fault_row_rel_err=errs["fwd_fault_row"]),
        _record("flash_attention_dq", path, shape, dq_ms, dq_plain, bwd_lib,
                *_dq_work(*shape, causal=causal, with_delta=delta_in_dq), errs["dq"][0],
                causal=causal, max_rel_err=errs["dq"][1], **lib_note, **dq_note),
        _record("flash_attention_dkv", path, shape, dkv_ms, dkv_plain, bwd_lib,
                *_dkv_work(*shape, causal=causal), max(errs["dk"][0], errs["dv"][0]),
                causal=causal, max_rel_err=max(errs["dk"][1], errs["dv"][1]), **lib_note),
    ]
    for rec in recs:
        _print_record(tag, rec, card)
    print(f"[{tag}] backward at {shape}: dq (Delta inside) + dkv {bwd_ms:.4f} ms, library "
          f"backward {bwd_lib:.4f} ms; dq with Delta {dq_with_delta_ms:.4f} ms, dq reading a "
          f"given Delta {dq_given_delta_ms:.4f} ms, the torch Delta the backward no longer "
          f"runs {torch_delta_ms:.4f} ms — {card}", flush=True)
    return recs


HOST_SHAPE, HOST_CALLS, HOST_ROUNDS = (1, 64, 12, 64), 200, 5


def _host_calls(dt: torch.dtype) -> dict:
    """The three wrappers as calls on HOST_SHAPE inputs of one dtype, B2 as
    the backward calls it (forming Delta)."""
    g = torch.Generator(device="cuda").manual_seed(400)
    q, k, v, do = (torch.randn(*HOST_SHAPE, generator=g, device="cuda").to(dt)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.flash_attention_dq(q, k, v, do, lse, o=o)[1]
    return {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(q, k, v),
        "flash_attention_dq": lambda: fa.flash_attention_dq(q, k, v, do, lse, o=o),
        "flash_attention_dkv": lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta),
    }


def phase_host_cost(card: str) -> dict:
    """The host's cost of one call of each wrapper: the wall clock of
    HOST_CALLS back-to-back calls, synchronised only at the end, median of
    HOST_ROUNDS rounds with bf16 and f32 in turns, at a shape whose kernels
    take less device time than the host takes to launch them (the device
    time per call, timed apart, is printed beside it to show that).  A bf16
    call encodes four TMA tensor maps (three for B1), an f32 call none; the
    rest of the path (checks, allocation, ctypes) is the same."""
    calls = {dt: _host_calls(dt) for dt in (torch.bfloat16, torch.float32)}
    res = {}
    for name in calls[torch.bfloat16]:
        walls = {dt: [] for dt in calls}
        for _ in range(HOST_ROUNDS):
            for dt, fns in calls.items():
                fn = fns[name]
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    fn()
                torch.cuda.synchronize()
                walls[dt].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        for dt, fns in calls.items():
            wall_us = statistics.median(walls[dt])
            # few calls a run, so that the host queues them within the
            # device-side sleep and only device time is timed
            device_us = _time_ms(fns[name], reps=4) * 1e3
            res[f"{name} {str(dt)[6:]}"] = {"wall_us_per_call": wall_us,
                                            "wall_us_rounds": walls[dt],
                                            "device_us_per_call": device_us}
            print(f"[host] {name} {str(dt)[6:]:8s} at {list(HOST_SHAPE)}: {wall_us:.2f} us a "
                  f"call, median of {HOST_ROUNDS} rounds of {HOST_CALLS} back-to-back calls "
                  f"({min(walls[dt]):.2f}..{max(walls[dt]):.2f}); device {device_us:.2f} us a "
                  f"call — {card}", flush=True)
    print("[host] " + json.dumps(res), flush=True)
    return res


async def _drain(req) -> list:
    toks = []
    while True:
        ev = await req.out.get()
        if ev is FINISHED:
            return toks
        toks.append(ev["token"])


def phase_parity(card: str) -> None:
    """Float32 GPT-2 small: paged prefill (kernel) + decode (einsum)
    tokens against the full-forward oracle (kernel) on the card."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, PROMPT_VOCAB, size=n).tolist() for n in PARITY_LENS]
    n_new = 8

    async def run():
        eng = LLMEngine(LLMConfig(model="small", dtype="float32", max_batch_size=4,
                                  block_size=16, num_blocks=256, temperature=0.0))
        reqs = [await eng.add_request(p, max_tokens=n_new) for p in prompts]
        outs = await asyncio.gather(*[_drain(r) for r in reqs])
        await eng.stop()
        return eng, outs

    t0 = time.perf_counter()
    eng, outs = asyncio.run(run())
    for p, got in zip(prompts, outs):
        want = gpt2.generate_greedy(eng.model, torch.tensor([p], device=eng.device), n_new)[0].tolist()
        if got != want:
            raise AssertionError(f"f32 greedy parity failed at prompt len {len(p)}: "
                                 f"engine {got} != oracle {want}")
    if eng.bm.blocks_in_use:
        raise AssertionError(f"f32 parity run leaked {eng.bm.blocks_in_use} KV blocks")
    print(f"[parity] GPT-2 small f32: {len(prompts)} prompts (len {min(PARITY_LENS)}.."
          f"{max(PARITY_LENS)}) x {n_new} greedy "
          f"tokens equal generate_greedy on the card ({time.perf_counter() - t0:.1f} s) — {card}",
          flush=True)


def _serve_mix():
    """The main path's configuration and traffic: bf16 GPT-2 small, 8
    lanes, 16 concurrent requests with prompts over every bucket from 8 to
    1024 and max_tokens from 16 to 64, made from a seed."""
    cfg = LLMConfig(model="small", dtype="bfloat16", max_batch_size=8, block_size=16,
                    num_blocks=256, temperature=0.0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, PROMPT_VOCAB, size=n).tolist() for n in SERVE_LENS]
    max_tokens = [int(m) for m in rng.integers(16, 65, size=len(SERVE_LENS))]
    return cfg, prompts, max_tokens


async def _serve_once(eng, prompts, max_tokens, on_start=None):
    """Warm the engine with one short request (set-up: cuBLAS state), then
    submit the mix at once and drain it."""
    await _drain(await eng.add_request([1, 2, 3], max_tokens=2))
    if on_start is not None:
        on_start()
    t0 = time.perf_counter()
    reqs = [await eng.add_request(p, max_tokens=m) for p, m in zip(prompts, max_tokens)]
    outs = await asyncio.gather(*[_drain(r) for r in reqs])
    torch.cuda.synchronize()
    return reqs, outs, time.perf_counter() - t0


def phase_serve(card: str) -> dict:
    """The main path, driven once through LLMEngine with the launch count
    set to 0 just before and read just after."""
    cfg, prompts, max_tokens = _serve_mix()
    lens = list(SERVE_LENS)

    def reset_counts():
        fa.flash_attention_fwd.launches = 0

    async def run():
        eng = LLMEngine(cfg)
        reqs, outs, wall = await _serve_once(eng, prompts, max_tokens, on_start=reset_counts)
        launches = fa.flash_attention_fwd.launches
        stats = eng.stats()
        await eng.stop()
        return eng, reqs, outs, wall, launches, stats

    eng, reqs, outs, wall, launches, stats = asyncio.run(run())
    n_layer = eng.model_cfg.n_layer
    vocab = eng.model_cfg.vocab_size
    for r, out in zip(reqs, outs):
        if len(out) != r.max_tokens or r.finish_reason != "length":
            raise AssertionError(f"request {r.request_id} (prompt {len(r.prompt)}) ended "
                                 f"{r.finish_reason} after {len(out)}/{r.max_tokens} tokens")
        if not all(0 <= t < vocab for t in out):
            raise AssertionError(f"token outside the vocabulary in {r.request_id}")
    leak = eng.stats()["kv_leak_report"]
    if leak["blocks_in_use"] or leak["live_sequences"]:
        raise AssertionError(f"KV leak after stop(): {leak}")
    if stats["preemptions_total"]:
        raise AssertionError("unexpected preemption in anonymous FIFO traffic")
    if launches != n_layer * len(reqs):
        raise AssertionError(f"flash kernel launched {launches} times, expected "
                             f"{n_layer} x {len(reqs)} prefills")
    ttft = sorted(r.t_first_token - r.t_submit for r in reqs)
    total = sum(len(o) for o in outs)
    decode_tokens = total - len(reqs)
    res = {
        "requests": len(reqs),
        "prompt_lens": lens,
        "max_tokens": max_tokens,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p95_s": float(np.percentile(ttft, 95)),
        "decode_tok_per_s": decode_tokens / wall,
        "output_tok_per_s": total / wall,
        "wall_s": wall,
        "decode_steps": stats["steps"],
        "flash_launches": launches,
        "kv_leak_report": leak,
        "card": card,
    }
    print(f"[serve] GPT-2 small bf16, {len(reqs)} requests (prompts {min(lens)}..{max(lens)}, "
          f"max_tokens {min(max_tokens)}..{max(max_tokens)}), {cfg.max_batch_size} lanes: "
          f"TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms p95 {res['ttft_p95_s'] * 1e3:.1f} ms, "
          f"decode {res['decode_tok_per_s']:.1f} tok/s, wall {wall:.2f} s, "
          f"flash launches {launches} = {n_layer} x {len(reqs)}, KV leak 0 — {card}", flush=True)
    print("[serve] " + json.dumps(res), flush=True)
    res["tokens"] = outs  # for phase 16's comparison; not printed
    return res


def _device_kernels(prof) -> list:
    """The profile's device events by name, without user annotations (such
    as the optimizer's step), whose device spans cover kernels already
    counted."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def phase_profile(card: str) -> dict:
    """Where the serving time goes: the same mix again under
    torch.profiler (device busy share, device time by kernel), and one
    T=1024 prefill timed alone with its attention share."""
    from torch.profiler import ProfilerActivity, profile

    cfg, prompts, max_tokens = _serve_mix()

    async def run():
        eng = LLMEngine(cfg)
        await _drain(await eng.add_request([1, 2, 3], max_tokens=2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, wall = await _serve_once(eng, prompts, max_tokens)
        await eng.stop()
        return eng, prof, wall

    eng, prof, wall = asyncio.run(run())
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    res = {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top],
    }
    print(f"[profile] serving mix under torch.profiler: wall {res['wall_ms']:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, idle share {res['device_idle_share']:.3f} — {card}", flush=True)
    for k in res["top_kernels"]:
        print(f"[profile]   {k['ms']:9.3f} ms  x{k['count']:5d}  {k['name']}", flush=True)

    toks = torch.randint(0, PROMPT_VOCAB, (1, 1024), device=eng.device)
    with torch.inference_mode():
        def prefill():
            gpt2.prefill_forward(eng.model, toks)
            torch.cuda.synchronize()

        prefill()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            prefill()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill()
    res["prefill_1024_ms"] = statistics.median(times)
    kernels = _device_kernels(prof)
    res["prefill_1024_device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
    res["prefill_1024_top"] = [
        {"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3}
        for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    ]
    print(f"[profile] one T=1024 prefill (12 layers, host clock to synchronize): "
          f"{res['prefill_1024_ms']:.3f} ms median of 5; device time "
          f"{res['prefill_1024_device_ms']:.3f} ms — {card}", flush=True)
    for k in res["prefill_1024_top"]:
        print(f"[profile]   {k['ms']:9.3f} ms  x{k['count']:5d}  {k['name']}", flush=True)
    print("[profile] " + json.dumps(res), flush=True)
    return res


def _train_batch(B: int, T: int, seed: int, device, vocab: int = PROMPT_VOCAB):
    """Tokens over the tokenizer's range from a seed, and their next-token
    targets."""
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, T + 1))
    toks = torch.from_numpy(toks).to(device)
    return toks[:, :-1], toks[:, 1:]


# A tensor whose largest CPU gradient entry is below this share of the
# model's largest has an exact gradient of zero and holds only rounding
# noise: an attention key bias (the softmax ignores a shift of all of a
# query's scores), or a ResNet branch behind a zero-initialised BatchNorm
# scale.  The ViT's key biases read 3.8e-10 to 4.6e-9 of the model's
# largest on the CPU, its next smallest tensor (a query bias) 1.9e-3.
ZERO_GRAD_SHARE = 1e-6


def _step_errors(card_model, cpu_model, grads: dict):
    """After one step from the same weights on the card and on the CPU:
    (max over tensors of max |g_card - g_cpu| / max |g_cpu|, max |p_card -
    p_cpu| over all entries, the same over the entries whose CPU gradient
    is at least 1e-2 of their tensor's largest, and {name: (max |g_card -
    g_cpu|, max |g_cpu|) over the model's largest CPU gradient entry} for
    the tensors at rounding level (ZERO_GRAD_SHARE)).  Noise agrees to no
    relative tolerance and AdamW follows its sign, so those tensors are
    held apart: none of their entries counts in the first and third
    numbers, and the caller holds the card's gradient there to rounding
    level too."""
    worst_g, worst_p, worst_p_sure = 0.0, 0.0, 0.0
    gtop = max(g.abs().max().item() for g in grads["cpu"].values())
    zero = {}
    params_cpu = dict(cpu_model.named_parameters())
    for n, p in card_model.named_parameters():
        gc, gr = grads["cuda"][n], grads["cpu"][n]
        gmax = gr.abs().max().item()
        diff = (p.detach().cpu() - params_cpu[n].detach()).abs()
        worst_p = max(worst_p, diff.max().item())
        if gmax < ZERO_GRAD_SHARE * gtop:
            zero[n] = ((gc - gr).abs().max().item() / gtop, gmax / gtop)
            continue
        worst_g = max(worst_g, (gc - gr).abs().max().item() / gmax)
        sure = gr.abs() >= 1e-2 * gmax
        if sure.any():
            worst_p_sure = max(worst_p_sure, diff[sure].max().item())
    return worst_g, worst_p, worst_p_sure, zero


def _zero_grads_ok(zero: dict) -> bool:
    return all(err <= ZERO_GRAD_SHARE for err, _ in zero.values())


def _fmt_zero(zero: dict) -> str:
    """The tensors at rounding level, for the phases' lines."""
    if not zero:
        return "no tensor at rounding level"
    return (f"{len(zero)} tensor(s) at rounding level (exact gradient zero, e.g. "
            f"{next(iter(zero))}): max|g_cpu| {max(g for _, g in zero.values()):.2e}, "
            f"max|g_card - g_cpu| {max(e for e, _ in zero.values()):.2e} of the model's "
            f"max|g| (tol {ZERO_GRAD_SHARE:g})")


def _adamw_step_parity(tag: str, label: str, cpu_model, make_step, batch, lr: float,
                       card: str, fwd_launches: int = None) -> dict:
    """One float32 AdamW step from the same weights on the card (copied
    from ``cpu_model``) and on the CPU, ``make_step(model)`` giving each its
    step: the loss, every gradient and every parameter after it.  With
    ``fwd_launches``, the card's step must launch B1 that many times.

    f32 on both sides, sums in other orders (cuBLAS, cuDNN and the kernels
    against the CPU's libraries and the plain versions): the loss to 1e-4
    relative, each gradient to 1e-3 of its largest entry; a tensor at
    rounding level (``_step_errors``) to ZERO_GRAD_SHARE of the model's
    largest.  After the step, AdamW's update is close to lr * g / |g|:
    entries whose gradient is at least 1e-2 of its tensor's largest agree
    to 1e-2 lr, the rest (gradients within float noise of zero) within 2
    lr."""
    card_model = copy.deepcopy(cpu_model).to("cuda")
    losses, grads = {}, {}
    for name, model in (("cuda", card_model), ("cpu", cpu_model)):
        step = make_step(model)
        launches = fa.flash_attention_fwd.launches
        losses[name] = step(model, *(t.to(name) for t in batch)).item()
        if (name == "cuda" and fwd_launches is not None
                and fa.flash_attention_fwd.launches - launches != fwd_launches):
            raise AssertionError(f"the card's {label} parity step did not run the flash kernels")
        grads[name] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    worst_g, worst_p, worst_p_sure, zero = _step_errors(card_model, cpu_model, grads)
    ok = (loss_err <= 1e-4 and worst_g <= 1e-3 and _zero_grads_ok(zero)
          and worst_p_sure <= 1e-2 * lr and worst_p <= 2 * lr and math.isfinite(losses["cuda"]))
    res = {"loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"], "loss_rel_err": loss_err,
           "grad_err_over_max": worst_g, "zero_grad_tensors": zero, "param_err": worst_p,
           "param_err_sure": worst_p_sure, "lr": lr}
    print(f"[{tag}] {label}, one AdamW step, card vs CPU: loss "
          f"{losses['cuda']:.6f} vs {losses['cpu']:.6f} (rel {loss_err:.2e}, tol 1e-4); "
          f"grads max|err|/max|g| {worst_g:.2e} (tol 1e-3); {_fmt_zero(zero)}; params "
          f"{worst_p_sure:.2e} where |g| >= 1e-2 max|g| (tol {1e-2 * lr:g}), {worst_p:.2e} "
          f"overall (tol {2 * lr:g}) {'ok' if ok else 'FAIL'} — {card}", flush=True)
    if not ok:
        raise AssertionError(f"{label} training parity failed: {res}")
    return res


def phase_train_parity(card: str) -> dict:
    """One float32 AdamW step of GPT-2 small at full width from the same
    weights, on the card (the three kernels) and on the CPU (their plain
    versions): the loss, every gradient and every parameter after it."""
    cfg = gpt2.GPT2Config.small(dtype=torch.float32, remat=False)
    cpu = gpt2.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return _adamw_step_parity(
        "train parity", "GPT-2 small f32 B=2 T=128", cpu,
        lambda m: gpt2.make_train_step(cfg, gpt2.make_adamw(m.parameters(), TRAIN_LR)),
        _train_batch(2, 128, seed=3, device="cpu"), TRAIN_LR, card, fwd_launches=cfg.n_layer)


def _launch_counts():
    return (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches)


def _reset_counts():
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkv.launches = 0


def phase_train(card: str) -> dict:
    """The training path, driven through make_train_step with the launch
    counts set to 0 just before and read just after; then one remat step,
    and a profiled window."""
    cfg = gpt2.GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.float32, remat=False)
    model = gpt2.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    step = gpt2.make_train_step(cfg, gpt2.make_adamw(model.parameters(), lr=TRAIN_LR))
    tokens, targets = _train_batch(TRAIN_B, TRAIN_T, seed=4, device="cuda")
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()
    losses, wall = _run_steps("training", step, model, (tokens, targets))
    launches = _launch_counts()
    want = (cfg.n_layer * n_steps,) * 3
    if launches != want:
        raise AssertionError(f"launches (B1, B2, B3) {launches} over {n_steps} steps, "
                             f"expected {want}: n_layer each a step")
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = TRAIN_B * TRAIN_T * TRAIN_STEPS / wall
    flops_tok = gpt2.flops_per_token(cfg, TRAIN_T)
    mfu = tok_s * flops_tok / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # remat: the same weights in a remat model; its step recomputes each
    # block's forward in the backward, so B1 launches twice a layer; the
    # loss is the forward's, and equals the plain model's at those weights
    rcfg = gpt2.GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.float32, remat=True)
    rmodel = gpt2.GPT2(rcfg).to("cuda")
    rmodel.load_state_dict(model.state_dict())
    rstep = gpt2.make_train_step(rcfg, gpt2.make_adamw(rmodel.parameters(), lr=TRAIN_LR))
    _reset_counts()
    loss_remat = rstep(rmodel, tokens, targets).item()
    remat_launches = _launch_counts()
    _reset_counts()
    loss_plain = step(model, tokens, targets).item()
    plain_launches = _launch_counts()
    del rmodel, rstep
    if remat_launches != (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer):
        raise AssertionError(f"remat step launched (B1, B2, B3) {remat_launches}, expected "
                             f"({2 * cfg.n_layer}, {cfg.n_layer}, {cfg.n_layer})")
    if plain_launches != (cfg.n_layer,) * 3:
        raise AssertionError(f"plain step launched {plain_launches}")
    # the forward runs the same operations on the same inputs in both
    if abs(loss_remat - loss_plain) > 1e-5 * abs(loss_plain):
        raise AssertionError(f"remat loss {loss_remat} != plain loss {loss_plain}")

    # where the time goes: two steps under torch.profiler
    prof = _profile_step(lambda: step(model, tokens, targets), steps=2)
    flash = prof["flash_ms_per_step"]
    res = {
        "config": "GPT-2 small, float32 params, bfloat16 compute, remat=False, "
                  f"B={TRAIN_B}, T={TRAIN_T}, AdamW lr {TRAIN_LR}",
        "losses": losses,
        "step_ms": step_ms,
        "tokens_per_s": tok_s,
        "flops_per_token": flops_tok,
        "mfu": mfu,
        "peak_memory_gb": peak_gb,
        "launches": {"flash_attention_fwd": launches[0], "flash_attention_dq": launches[1],
                     "flash_attention_dkv": launches[2], "steps": n_steps},
        "remat_launches": list(remat_launches),
        "loss_remat": loss_remat,
        "loss_plain": loss_plain,
        **prof,
        "card": card,
    }
    print(f"[train] GPT-2 small bf16 compute / f32 params, B={TRAIN_B} T={TRAIN_T}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {n_steps} steps; step {step_ms:.2f} ms "
          f"(mean of {TRAIN_STEPS} timed steps), {tok_s:.0f} tok/s, MFU {mfu:.4f} at "
          f"{flops_tok / 1e9:.4f} GFLOP/token; peak memory {peak_gb:.2f} GB; launches "
          f"B1/B2/B3 {launches} = {cfg.n_layer} x {n_steps} — {card}", flush=True)
    print(f"[train] remat step: launches B1/B2/B3 {remat_launches}, loss {loss_remat:.6f} = "
          f"plain {loss_plain:.6f} — {card}", flush=True)
    print(f"[train] profiled: {res['profiled_step_ms']:.2f} ms a step, device busy "
          f"{res['device_busy_ms_per_step']:.2f} ms, idle share {res['device_idle_share']:.4f}; "
          f"flash per step: fwd {flash['flash_fwd_bf16_kernel']:.3f} ms, dq "
          f"{flash['flash_dq_bf16_kernel']:.3f} ms, dkv {flash['flash_dkv_bf16_kernel']:.3f} ms "
          f"— {card}", flush=True)
    for k in res["top_kernels"]:
        print(f"[train]   {k['ms_per_step']:9.3f} ms/step  x{k['count']:5d}  {k['name']}",
              flush=True)
    print("[train] " + json.dumps(res), flush=True)
    return res


# ----------------------------------------------------------------------
# Llama-1B: the kernels at head dim 128 behind the GQA repeat, an f32 step
# at full width against the CPU, and the training path
# ----------------------------------------------------------------------
LLAMA_B, LLAMA_T = 4, 4096  # llama_1b's max_seq_len: 16,384 tokens a step
LLAMA_VOCAB = 32000


def _gqa_inputs(B: int, T: int, seed: int):
    """Llama-1B's attention inputs on the card in bf16: q [B, T, 16, 128],
    k and v drawn for its 8 KV heads and repeated to 16 as LlamaAttention
    repeats them (contiguous), and dO [B, T, 16, 128]."""
    cfg = llama.LlamaConfig.llama_1b()
    rep = cfg.n_head // cfg.n_kv_head
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(heads):
        return torch.randn(B, T, heads, cfg.d_head, generator=g, device="cuda").to(torch.bfloat16)

    q = draw(cfg.n_head)
    k, v = (torch.repeat_interleave(draw(cfg.n_kv_head), rep, dim=2) for _ in range(2))
    return q, k, v, draw(cfg.n_head)


def phase_llama_kernels(card: str) -> list:
    """B1, B2 and B3 at Llama-1B's attention, the training path's [4, 4096,
    16, 128]: held against their plain versions (the tolerances of the
    training shape, relative for the gradients, since their scale grows
    with T), then timed there; returns the records (launches are filled in
    by the training phase)."""
    q, k, v, do = _gqa_inputs(LLAMA_B, LLAMA_T, seed=501)
    errs = _hold_bf16_kernels("llama kernels", "Llama-1B attention", "GQA-repeated k/v",
                              q, k, v, do)
    torch.cuda.empty_cache()
    recs = _time_bf16_kernels("llama kernels", "llama_train", q, k, v, do, errs, card,
                              plain_reps=1)
    del q, k, v, do
    torch.cuda.empty_cache()
    return recs


def phase_llama_parity(card: str) -> dict:
    """One float32 AdamW step at Llama-1B's full width (d_model 2048, 16
    heads over 8 KV heads, d_ff 5504, vocab 32000) and 2 of its layers,
    B=1, T=256, on the card (the kernels at D=128) and on the CPU."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama_1b(dtype=torch.float32), n_layer=2,
                              remat=False)
    cpu = llama.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return _adamw_step_parity(
        "llama parity", "Llama-1B widths x 2 layers f32 B=1 T=256", cpu,
        lambda m: llama.make_train_step(cfg, gpt2.make_adamw(m.parameters(), TRAIN_LR)),
        _train_batch(1, 256, seed=6, device="cpu", vocab=LLAMA_VOCAB), TRAIN_LR, card,
        fwd_launches=cfg.n_layer)


def _llama_flops_per_token(cfg, n_params: int, T: int) -> float:
    """Model FLOPs a token of a training step (no remat recompute): 6 per
    weight outside the embedding, and 6 T d_model a layer for causal
    attention (QK^T and PV over T/2 keys on average, forward and
    backward)."""
    return 6.0 * (n_params - cfg.vocab_size * cfg.d_model) + 6.0 * cfg.n_layer * T * cfg.d_model


def _kind(kernel: str) -> str:
    """A device kernel's kind by its name: the port's flash kernels, the
    cuBLAS/cuDNN products, torch's elementwise kernels and copies, its
    reductions, or other."""
    if "flash_" in kernel:
        return "flash"
    if any(w in kernel for w in ("nvjet", "gemm", "cutlass", "sm90_", "conv", "wgrad",
                                 "dgrad", "fprop", "xmma", "cudnn")):
        return "matmul/conv"
    if "elementwise" in kernel or "copy" in kernel:
        return "elementwise"
    if "reduce" in kernel or "norm" in kernel.lower():
        return "reduction"
    return "other"


def _fmt_ms(by_kind: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in by_kind.items())


def _profile_step(run, steps: int = 1) -> dict:
    """``steps`` calls of ``run`` (a training step) under torch.profiler:
    a step's wall time to a synchronize, the device's busy time a step and
    idle share, device time a step by kind and by kernel (``count`` over
    all the steps), and the flash kernels' time a step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / steps
    kernels = _device_kernels(prof)

    def ms(events):  # device time a step
        return sum(e.self_device_time_total for e in events) / 1e3 / steps

    busy_ms = ms(kernels)
    by_kind = {}
    for e in kernels:
        by_kind[_kind(e.key)] = by_kind.get(_kind(e.key), 0.0) + ms([e])
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "profiled_step_ms": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        # each kernel's bf16 instantiations: flash_dq_bf16_kernel<64> and the
        # warp-specialised flash_dq_bf16_ws_kernel<128> both count as B2
        "flash_ms_per_step": {
            name: ms([e for e in kernels if name[:-len("_kernel")] in e.key])
            for name in ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel",
                         "flash_dkv_bf16_kernel")},
        "top_kernels": [{"name": e.key[:80], "count": e.count, "ms_per_step": ms([e])}
                        for e in top[:15]],
    }


def phase_llama_train(card: str) -> dict:
    """The main path: Llama-1B at full width and depth, float32 params
    with bfloat16 compute and remat (the reference's defaults), B=4,
    T=4096, AdamW at bench.py's hyperparameters, driven through
    make_train_step with the launch counts set to 0 just before and read
    just after (B1 twice a layer, B2 and B3 once); then one step under
    torch.profiler."""
    cfg = llama.LlamaConfig.llama_1b()
    model = llama.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    step = llama.make_train_step(cfg, gpt2.make_adamw(model.parameters(), lr=TRAIN_LR))
    tokens, targets = _train_batch(LLAMA_B, LLAMA_T, seed=7, device="cuda", vocab=LLAMA_VOCAB)
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()
    losses, wall = _run_steps("Llama training", step, model, (tokens, targets))
    launches = _launch_counts()
    L = cfg.n_layer
    want = (2 * L * n_steps, L * n_steps, L * n_steps)
    if launches != want:
        raise AssertionError(f"Llama launches (B1, B2, B3) {launches} over {n_steps} steps, "
                             f"expected {want}: B1 twice a layer (remat), B2 and B3 once")
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = LLAMA_B * LLAMA_T * TRAIN_STEPS / wall
    n_params = llama.num_params(model)
    flops_tok = _llama_flops_per_token(cfg, n_params, LLAMA_T)
    mfu = tok_s * flops_tok / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    prof = _profile_step(lambda: step(model, tokens, targets))
    flash = prof["flash_ms_per_step"]
    res = {
        "config": f"Llama-1B (16 layers, d_model 2048, 16 heads over 8 KV heads, d_ff 5504, "
                  f"vocab 32000), float32 params, bfloat16 compute, remat=True, B={LLAMA_B}, "
                  f"T={LLAMA_T}, AdamW lr {TRAIN_LR}",
        "params": n_params,
        "losses": losses,
        "step_ms": step_ms,
        "tokens_per_s": tok_s,
        "flops_per_token": flops_tok,
        "mfu": mfu,
        "peak_memory_gb": peak_gb,
        "launches": {"flash_attention_fwd": launches[0], "flash_attention_dq": launches[1],
                     "flash_attention_dkv": launches[2], "steps": n_steps},
        **prof,
        "card": card,
    }
    print(f"[llama train] Llama-1B bf16 compute / f32 params, remat, B={LLAMA_B} T={LLAMA_T} "
          f"({n_params} params): loss {losses[0]:.4f} -> {losses[-1]:.4f} over {n_steps} "
          f"steps; step {step_ms:.2f} ms (mean of {TRAIN_STEPS} timed steps), {tok_s:.0f} "
          f"tok/s, MFU {mfu:.4f} at {flops_tok / 1e9:.4f} GFLOP/token; peak memory "
          f"{peak_gb:.2f} GB; launches B1/B2/B3 {launches} = ({2 * L}, {L}, {L}) x {n_steps} "
          f"— {card}", flush=True)
    print(f"[llama train] profiled step: {res['profiled_step_ms']:.2f} ms, device busy "
          f"{res['device_busy_ms_per_step']:.2f} ms, idle share {res['device_idle_share']:.4f}; "
          f"by kind {_fmt_ms(res['device_ms_by_kind'])}; flash per step: fwd "
          f"{flash['flash_fwd_bf16_kernel']:.3f} ms, dq {flash['flash_dq_bf16_kernel']:.3f} ms, "
          f"dkv {flash['flash_dkv_bf16_kernel']:.3f} ms — {card}", flush=True)
    for k in res["top_kernels"]:
        print(f"[llama train]   {k['ms_per_step']:9.3f} ms/step  x{k['count']:5d}  {k['name']}",
              flush=True)
    print("[llama train] " + json.dumps(res), flush=True)
    return res


# ----------------------------------------------------------------------
# Vision and small models: ResNet, ViT, MLP, MoE (cuDNN, cuBLAS and torch
# ops; no kernel of the port runs here)
# ----------------------------------------------------------------------
RESNET_B, RESNET_LR = 512, 0.1  # bench_resnet.py's batch and SGD(0.1, momentum 0.9)


def _class_images(B: int, shape: tuple, seed: int, device):
    """Synthetic labelled images from a seed: each of 10 classes has a
    random prototype, and an image is its class's prototype plus unit
    noise, so a few steps can lower the loss.  (x [B, *shape] float32,
    y [B] int64) on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    protos = torch.randn(10, *shape, generator=g, device=device)
    y = torch.randint(0, 10, (B,), generator=g, device=device)
    return protos[y] + torch.randn(B, *shape, generator=g, device=device), y


def _run_steps(tag: str, step, model, batch) -> tuple:
    """TRAIN_WARMUP + TRAIN_STEPS steps on one batch: (losses, seconds of
    the timed steps); raises unless the loss is finite and falling."""
    losses = [step(model, *batch) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(model, *batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [x.item() for x in losses]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} loss not finite and falling: {losses}")
    return losses, wall


def phase_resnet(card: str) -> dict:
    """One float32 ResNet step at resnet18's widths (B=8, 32x32) on the card
    and on the CPU from the same weights, SGD with momentum: the loss,
    every gradient, the parameters and the new running statistics after
    it.  Then ResNet-50 at bench_resnet.py's configuration: bf16 compute,
    B=512 32x32x3 images, SGD lr 0.1 momentum 0.9, 13 steps."""
    cfg = resnet.ResNetConfig.resnet18(dtype=torch.float32)
    cpu = resnet.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_model = copy.deepcopy(cpu).to("cuda")
    x, y = _class_images(8, (32, 32, 3), seed=8, device="cpu")
    losses, grads = {}, {}
    for name, model in (("cuda", card_model), ("cpu", cpu)):
        step = resnet.make_train_step(cfg, torch.optim.SGD(model.parameters(), lr=RESNET_LR,
                                                           momentum=0.9))
        losses[name] = step(model, x.to(name), y.to(name)).item()
        grads[name] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    # f32 on both sides, cuDNN against the CPU's convolutions: the loss to
    # 1e-4 relative, each gradient and each new running statistic to 1e-3
    # and 1e-4 of its tensor's largest entry (a gradient at rounding level,
    # behind a zero-initialised BatchNorm scale, as _step_errors says); a
    # first SGD step moves each
    # parameter by lr x its gradient, so the parameters agree to lr x the
    # gradient tolerance (plus float32 rounding of the parameter, 1e-6 of
    # its largest entry)
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    worst_g, _, _, zero = _step_errors(card_model, cpu, grads)
    cpu_params, cpu_bufs = dict(cpu.named_parameters()), dict(cpu.named_buffers())
    worst_p = max(((p.detach().cpu() - cpu_params[n].detach()).abs().max()
                   / (RESNET_LR * 1e-3 * grads["cpu"][n].abs().max()
                      + 1e-6 * cpu_params[n].detach().abs().max())).item()
                  for n, p in card_model.named_parameters())
    worst_s = max(_rel(b.cpu(), cpu_bufs[n])[1] for n, b in card_model.named_buffers())
    ok = (math.isfinite(losses["cuda"]) and loss_err <= 1e-4 and worst_g <= 1e-3
          and _zero_grads_ok(zero) and worst_p <= 1.0 and worst_s <= 1e-4)
    res = {"parity": {"loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"],
                      "loss_rel_err": loss_err, "grad_err_over_max": worst_g,
                      "zero_grad_tensors": zero, "param_err_over_tol": worst_p,
                      "batch_stats_err_over_max": worst_s}}
    print(f"[resnet] resnet18 widths f32 B=8 32x32, one SGD-momentum step, card vs CPU: loss "
          f"{losses['cuda']:.6f} vs {losses['cpu']:.6f} (rel {loss_err:.2e}, tol 1e-4); grads "
          f"max|err|/max|g| {worst_g:.2e} (tol 1e-3); {_fmt_zero(zero)}; params "
          f"{worst_p:.2e} of their tolerance; "
          f"new batch stats max|err|/max {worst_s:.2e} (tol 1e-4) {'ok' if ok else 'FAIL'} "
          f"— {card}", flush=True)
    if not ok:
        raise AssertionError(f"ResNet training parity failed: {res}")
    del cpu, card_model

    cfg = resnet.ResNetConfig.resnet50()
    model = resnet.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = resnet.make_train_step(cfg, torch.optim.SGD(model.parameters(), lr=RESNET_LR,
                                                       momentum=0.9))
    batch = _class_images(RESNET_B, (32, 32, 3), seed=9, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    losses, wall = _run_steps("ResNet-50", step, model, batch)
    if not all(bool(torch.isfinite(b).all()) for b in model.buffers()):
        raise AssertionError("ResNet-50 running statistics not finite")
    res["resnet50"] = {"losses": losses, "step_ms": wall / TRAIN_STEPS * 1e3,
                       "images_per_s": RESNET_B * TRAIN_STEPS / wall,
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "params": resnet.num_params(model), "card": card}
    r = res["resnet50"]
    r.update(_profile_step(lambda: step(model, *batch)))
    print(f"[resnet] ResNet-50 bf16 compute / f32 params, B={RESNET_B} 32x32x3, SGD lr "
          f"{RESNET_LR} momentum 0.9: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{len(losses)} steps; step {r['step_ms']:.2f} ms (mean of {TRAIN_STEPS}), "
          f"{r['images_per_s']:.0f} images/s, peak memory {r['peak_memory_gb']:.2f} GB; "
          f"profiled step {r['profiled_step_ms']:.2f} ms, device busy "
          f"{r['device_busy_ms_per_step']:.2f} ms, by kind {_fmt_ms(r['device_ms_by_kind'])} "
          f"— {card}", flush=True)
    for k in r["top_kernels"][:8]:
        print(f"[resnet]   {k['ms_per_step']:9.3f} ms/step  x{k['count']:5d}  {k['name']}",
              flush=True)
    print("[resnet] " + json.dumps(res), flush=True)
    return res


def _small_model(tag: str, label: str, module, f32_cfg, bf16_cfg, shape: tuple,
                 parity_b: int, train_b: int, card: str) -> dict:
    """An f32 AdamW step card against CPU at ``parity_b``, then 13 bf16
    AdamW steps at ``train_b`` with a falling loss (lr 3e-4, bench.py's
    AdamW)."""
    cpu = module.init_model(f32_cfg, torch.Generator().manual_seed(0), device="cpu")
    res = {"parity": _adamw_step_parity(
        tag, f"{label} f32 B={parity_b}", cpu,
        lambda m: module.make_train_step(f32_cfg, gpt2.make_adamw(m.parameters(), TRAIN_LR)),
        _class_images(parity_b, shape, seed=10, device="cpu"), TRAIN_LR, card)}
    model = module.init_model(bf16_cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = module.make_train_step(bf16_cfg, gpt2.make_adamw(model.parameters(), TRAIN_LR))
    losses, wall = _run_steps(label, step, model,
                              _class_images(train_b, shape, seed=11, device="cuda"))
    res["bf16"] = {"losses": losses, "step_ms": wall / TRAIN_STEPS * 1e3,
                   "samples_per_s": train_b * TRAIN_STEPS / wall, "card": card}
    print(f"[{tag}] {label} bf16 compute, B={train_b}, AdamW lr {TRAIN_LR}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps; step "
          f"{res['bf16']['step_ms']:.3f} ms, {res['bf16']['samples_per_s']:.0f} samples/s "
          f"— {card}", flush=True)
    return res


def phase_vit(card: str) -> dict:
    """ViT at its default config (32x32 images in 4x4 patches, d_model 192,
    6 layers, 3 heads): f32 step card vs CPU, then bf16 steps."""
    return _small_model("vit", "ViT (32/4, d 192, 6 layers, 3 heads)", vit,
                        vit.ViTConfig(dtype=torch.float32), vit.ViTConfig(), (32, 32, 3),
                        parity_b=8, train_b=256, card=card)


def phase_mlp(card: str) -> dict:
    """The MNIST MLP at its default config (784-256-256-10): f32 step card
    vs CPU, then bf16 steps."""
    return _small_model("mlp", "MLP 784-256-256-10", mlp, mlp.MLPConfig(),
                        mlp.MLPConfig(dtype=torch.bfloat16), (28, 28), parity_b=128,
                        train_b=512, card=card)


def phase_moe(card: str) -> dict:
    """MoEMLP at its default widths (d_model 128, d_ff 256, 8 experts, top
    2, capacity factor 2) in float32 on x [4, 256, 128]: the forward and a
    backward from a random cotangent on the card and on the CPU from the
    same weights.  f32 on both sides in other summation orders: the output
    to 1e-4 of its largest entry, the aux loss to 1e-4 relative, each
    gradient (the weights' and the input's) to 1e-3 of its largest."""
    cfg = moe.MoEConfig(dtype=torch.float32)
    cpu = moe.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_model = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(12)
    x = torch.randn(4, 256, cfg.d_model, generator=g)
    w = torch.randn(4, 256, cfg.d_model, generator=g)
    got = {}
    for name, model in (("cuda", card_model), ("cpu", cpu)):
        xx = x.to(name).requires_grad_(True)
        out, aux = model(xx)
        ((out * w.to(name)).sum() + aux).backward()
        got[name] = {"out": out.detach().cpu(), "aux": aux.item(), "dx": xx.grad.cpu(),
                     **{n: p.grad.cpu() for n, p in model.named_parameters()}}
    c, r = got["cuda"], got["cpu"]
    out_err = _rel(c["out"], r["out"])[1]
    aux_err = abs(c["aux"] - r["aux"]) / abs(r["aux"])
    grad_err = max(_rel(c[n], r[n])[1] for n in c if n not in ("out", "aux"))
    ok = out_err <= 1e-4 and aux_err <= 1e-4 and grad_err <= 1e-3
    res = {"out_err_over_max": out_err, "aux_cuda": c["aux"], "aux_cpu": r["aux"],
           "aux_rel_err": aux_err, "grad_err_over_max": grad_err, "card": card,
           "ep_mesh": _moe_on_ep_mesh(cpu, x)}
    print(f"[moe] MoEMLP f32 (d 128, d_ff 256, 8 experts, top 2) x [4, 256, 128], card vs CPU: "
          f"out max|err|/max {out_err:.2e} (tol 1e-4); aux {c['aux']:.6f} vs {r['aux']:.6f} "
          f"(rel {aux_err:.2e}, tol 1e-4); grads max|err|/max|g| {grad_err:.2e} (tol 1e-3) "
          f"{'ok' if ok else 'FAIL'} — {card}", flush=True)
    ep = res["ep_mesh"]
    print(f"[moe] the same weights placed by moe_sharding_rules() on a one-card {{'ep': 1}} mesh: "
          f"specs {ep['specs']}, placements {ep['placements']}; output and aux loss equal to the "
          f"unsharded card's bit for bit: {ep['bit_equal']} — {card}", flush=True)
    if not ok:
        raise AssertionError(f"MoE parity failed: {res}")
    if not ep["bit_equal"] or ep["specs"]["experts_gate"][0] != "ep":
        raise AssertionError(f"MoE under moe_sharding_rules(): {ep}")
    return res


def _moe_on_ep_mesh(cpu_model, x) -> dict:
    """The MoE forward with its parameters placed by moe_sharding_rules()
    on a one-card {"ep": 1} mesh (the stacked experts Shard(0) over ep,
    the router replicated), against the same weights unsharded on the
    card."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from ray_tpu_torch.parallel import create_mesh
    from ray_tpu_torch.parallel.sharding import infer_param_spec, shard_module

    formed = not dist.is_initialized()
    mesh = create_mesh({"ep": 1}, device_type="cuda")
    try:
        plain = copy.deepcopy(cpu_model).to("cuda")
        sharded = copy.deepcopy(cpu_model).to("cuda")
        specs = infer_param_spec(sharded, moe.moe_sharding_rules(), mesh)
        shard_module(sharded, mesh, specs)
        xx = x.to("cuda")
        with torch.no_grad():
            out, aux = plain(xx)
            with implicit_replication():
                s_out, s_aux = sharded(xx)
        s_out, s_aux = (t.full_tensor() if hasattr(t, "full_tensor") else t for t in (s_out, s_aux))
        return {"specs": specs,
                "placements": {n: str(tuple(p.placements)) for n, p in sharded.named_parameters()},
                "bit_equal": bool(torch.equal(s_out, out) and torch.equal(s_aux, aux))}
    finally:
        if formed:
            dist.destroy_process_group()


# ----------------------------------------------------------------------
# The runtime: GPU as a resource, a num_gpus=1 actor, and the training
# path inside TorchTrainer.fit() on one GPU worker
# ----------------------------------------------------------------------
# head_main, raylet_main, default_worker, and the Ray Client server a head
# started with ray_client_server_port spawns
_RUNTIME_ENTRY = ("ray_tpu_torch._private.", "ray_tpu_torch.util.client.server_main")


def _port_processes() -> dict:
    """pid -> command line of every live process running one of the
    port's runtime entry points."""
    out = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if any(entry in cmd for entry in _RUNTIME_ENTRY):
            out[int(pid)] = cmd.strip()
    return out


def _maps_libcuda(pid: int) -> bool:
    """Whether the process has the CUDA driver library mapped (a process
    that never loaded it holds no CUDA context)."""
    with open(f"/proc/{pid}/maps") as f:
        return "libcuda" in f.read()


def _maps_uvm(pid: int) -> bool:
    """Whether the process maps /dev/nvidia-uvm, as the CUDA driver does
    once it makes a context: a witness that does not ask torch.  On an H100
    machine with torch 2.11+cu128, ``import torch`` alone maps libcuda and
    ``torch.cuda.is_available()`` opens /dev/nvidiactl and the card's node,
    but only the first allocation maps /dev/nvidia-uvm (a probe of each
    step).  nvidia-smi's compute apps cannot stand in: in a container it
    lists pids of another namespace."""
    with open(f"/proc/{pid}/maps") as f:
        return "/dev/nvidia-uvm" in f.read()


def _cuda_state(actor) -> tuple:
    """(pid, whether torch holds a CUDA context) of the actor's process, for
    ``__ray_call__``; ``_maps_uvm`` witnesses the same from outside torch
    (``import torch`` alone maps libcuda, so the libcuda check of a
    process that imports torch says nothing)."""
    return os.getpid(), bool(torch.cuda.is_initialized())


def _compute_app_pids() -> set:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return {int(x) for x in out.split() if x.strip().isdigit()}


# (b) the profiled fit and (c) the Ray Client pool
_CLIENT_PORT_ENV = "RAY_TPU_TORCH_ray_client_server_port"
# (b): timed steps of the profiled fit (phase 9's TRAIN_STEPS, then more, so
# a TRAINER_PROFILE_S capture that starts TRAINER_PROFILE_DELAY_S after the
# loop's first step was seen ends before the loop does: the worker goes
# with fit()).  The delay outlasts most of the warm-up (its three steps
# took 2.3 and 2.8 s on two card machines), so the capture falls in the
# timed steps.
PROFILED_STEPS = 60
TRAINER_PROFILE_S, TRAINER_PROFILE_DELAY_S, PROBE_S = 2.0, 2.5, 0.2


class _Background:
    """fn() on a daemon thread; join() returns its result or raises what it
    raised."""

    def __init__(self, fn, *args):
        import threading

        self._out = {}

        def run():
            try:
                self._out["value"] = fn(*args)
            except BaseException as e:  # noqa: BLE001 — re-raised by join()
                self._out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True, name="chip-smoke-bg")
        self._thread.start()

    def join(self, timeout: float):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise AssertionError(f"a background check did not end within {timeout} s")
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def _alive_actor(match, deadline_s: float = 300.0) -> dict:
    """The first ALIVE actor of util.state.list_actors() that ``match``
    accepts, waiting for it up to ``deadline_s``."""
    from ray_tpu_torch.util import state

    deadline = time.monotonic() + deadline_s
    while True:
        found = [a for a in state.list_actors([("state", "=", "ALIVE")]) if match(a)]
        if found:
            return found[0]
        if time.monotonic() > deadline:
            raise AssertionError(f"no live actor matched within {deadline_s} s: "
                                 f"{state.list_actors()}")
        time.sleep(0.1)


def _profile_trainer() -> dict:
    """(b)'s capture, run beside fit(): find the training worker through
    util.state.list_actors, probe it with PROBE_S captures until its stacks
    show the loop's step (gpt2_loop.py:one_step), wait out the first, slow
    step, then take the TRAINER_PROFILE_S capture."""
    from ray_tpu_torch.util import state

    t0 = time.perf_counter()
    worker = _alive_actor(lambda a: a["class_name"].endswith("RayTrainWorker"))
    t_found = time.perf_counter()
    probes, deadline = 0, time.monotonic() + 300
    while True:
        probe = state.profile(worker["actor_id"], duration_s=PROBE_S)
        probes += 1
        if not probe.complete:
            raise AssertionError(f"a probe of the training worker failed: {probe.errors}")
        if any("gpt2_loop.py:one_step" in k for k in probe.merged_samples()):
            break
        if time.monotonic() > deadline:
            raise AssertionError("the training worker never reached its steps")
    t_step = time.perf_counter()
    time.sleep(TRAINER_PROFILE_DELAY_S)
    # mode "cpu": threads parked in a wait (the runtime's flush and RPC
    # loops) drop out, the training thread's host time stays
    result = state.profile(worker["actor_id"], duration_s=TRAINER_PROFILE_S, mode="cpu")
    return {"worker": worker, "result": result, "probes": probes,
            "find_s": t_found - t0, "probe_s": t_step - t_found,
            "capture_s": time.perf_counter() - t_step}


def _hold_trainer_profile(card: str, prof: dict, m: dict) -> dict:
    """(b)'s holds: the capture is complete with samples, the loop's frames
    have a share of them, the GCS profile table has the record; its top
    frames and the window it covered are printed."""
    from ray_tpu_torch.util import state

    result, worker = prof["result"], prof["worker"]
    rec = result.profiles[0] if result.profiles else {}
    share = result.attribution("gpt2_loop")
    sid = rec.get("session_id")
    shipped, deadline = [], time.monotonic() + 15
    while sid and not shipped and time.monotonic() < deadline:
        shipped = state.profiles(session_id=sid)
        if not shipped:
            time.sleep(0.2)
    # the dump stops the sampler, whose thread stamps the end after it: the
    # record shipped at that end has it
    stamps = m["timeline"]
    timed = (stamps["timed"], stamps["steps"])
    start = rec.get("started_at") or 0.0
    end = (rec.get("ended_at") or (shipped[0].get("ended_at") if shipped else None)
           or start + TRAINER_PROFILE_S)
    window = (start, end)
    prof["timed_window_s"] = timed[1] - timed[0]
    prof["timed_overlap_s"] = max(0.0, min(window[1], timed[1]) - max(window[0], timed[0]))
    top = result.top_frames(10)
    out = {"worker": worker["actor_id"], "pid": worker["pid"], "complete": result.complete,
           "errors": result.errors, "total_samples": result.total_samples,
           "hz": rec.get("hz"), "gpt2_loop_share": share, "in_profile_table": bool(shipped),
           "top_frames": [[f, c, round(fr, 4)] for f, c, fr in top],
           "window": {"started_after_model_s": window[0] - stamps["model"],
                      "ended_before_steps_end_s": timed[1] - window[1],
                      "timed_window_s": prof["timed_window_s"],
                      "timed_overlap_s": prof["timed_overlap_s"]},
           "probes": prof["probes"], "find_s": prof["find_s"], "probe_s": prof["probe_s"],
           "capture_s": prof["capture_s"]}
    print(f"[runtime] util.state.profile(training worker {worker['actor_id'][:8]}, pid "
          f"{worker['pid']}, duration_s={TRAINER_PROFILE_S}, mode='cpu') during fit(): complete "
          f"{result.complete}, {result.total_samples} samples at {rec.get('hz')} Hz, share in "
          f"gpt2_loop frames {share:.4f}, in state.profiles() {bool(shipped)}; the window "
          f"began {out['window']['started_after_model_s']:.2f} s after the model was built "
          f"({prof['probes']} probes of {PROBE_S} s found the steps, then "
          f"{TRAINER_PROFILE_DELAY_S} s) and ended {out['window']['ended_before_steps_end_s']:.2f}"
          f" s before the steps did, covering {prof['timed_overlap_s']:.2f} s of the "
          f"{prof['timed_window_s']:.2f} s timed window — {card}", flush=True)
    for f, c, fr in top:
        print(f"[runtime]   top frame {f}: {c} samples ({fr:.4f})", flush=True)
    if not (result.complete and result.total_samples > 0 and share > 0 and shipped):
        raise AssertionError(f"the trainer's capture failed its holds: {out}")
    return out


# (c): the ray:// driver's script.  It runs in a process of its own that
# imports the port and numpy and never torch: the pool's actors (defined
# here, so pickled by value) import torch in their own processes.
CLIENT_B, CLIENT_T, CLIENT_BATCHES, CLIENT_SEED = 4, 512, 8, 0
_CLIENT_SCRIPT = r"""
import json, os, sys, time

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.util import ActorPool
from ray_tpu_torch.util.queue import Queue

address, out_dir = sys.argv[1], sys.argv[2]
B, T, N, SEED, VOCAB = (int(x) for x in sys.argv[3:8])
t0 = time.perf_counter()
ray_tpu_torch.init(address)
t_conn = time.perf_counter()


@ray_tpu_torch.remote(num_gpus=0.5)
class PoolGPT2:
    def __init__(self, seed):
        import torch

        from ray_tpu_torch.models import gpt2

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = gpt2.GPT2Config.small(dtype=torch.float32, remat=False)
        model = gpt2.init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
        self.model = model.to("cuda").eval()

    def ready(self):
        return os.getpid()

    def forward(self, tokens, q):
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        before = fa.flash_attention_fwd.launches
        with torch.inference_mode():
            logits = self.model(torch.tensor(tokens).to("cuda"))[:, -1]
            ids = logits.argmax(-1)
        out = (logits.cpu().numpy(), ids.cpu().numpy())
        q.put(fa.flash_attention_fwd.launches - before)
        return out


actors = [PoolGPT2.remote(SEED) for _ in range(2)]
pids = ray_tpu_torch.get([a.ready.remote() for a in actors], timeout=600)
t_ready = time.perf_counter()
batches = [np.random.default_rng(200 + i).integers(0, VOCAB, size=(B, T)) for i in range(N)]
q = Queue()
pool = ActorPool(actors)
ordered = list(pool.map(lambda a, b: a.forward.remote(b, q), batches))
t_map = time.perf_counter()
counts = [q.get(timeout=120) for _ in range(N)]
unordered = list(pool.map_unordered(lambda a, b: a.forward.remote(b, q), batches))
counts_unordered = [q.get(timeout=120) for _ in range(N)]
t_end = time.perf_counter()
q.shutdown()
with open("/proc/self/maps") as f:
    maps = f.read()
np.savez(os.path.join(out_dir, "out.npz"), logits=np.stack([o[0] for o in ordered]),
         ids=np.stack([o[1] for o in ordered]),
         u_logits=np.stack([o[0] for o in unordered]), u_ids=np.stack([o[1] for o in unordered]))
summary = json.dumps({
    "launches": counts, "launches_unordered": counts_unordered,
    "actor_ids": [a._actor_id.hex() for a in actors], "actor_pids": pids,
    "libtorch": "libtorch" in maps, "libcuda": "libcuda" in maps,
    "torch_imported": "torch" in sys.modules, "pid": os.getpid(),
    "connect_s": t_conn - t0, "actors_ready_s": t_ready - t_conn, "map_s": t_map - t_ready,
    "unordered_s": t_end - t_map,
})
with open(os.path.join(out_dir, "summary.tmp"), "w") as f:
    f.write(summary)
os.replace(os.path.join(out_dir, "summary.tmp"), os.path.join(out_dir, "summary.json"))
# stay connected (the actors alive) until the driver has read the
# timeline: a killed actor's unflushed task events die with it
deadline = time.monotonic() + 120
while not os.path.exists(os.path.join(out_dir, "release")) and time.monotonic() < deadline:
    time.sleep(0.05)
ray_tpu_torch.shutdown()
print(summary)
"""


def _client_pool(card: str, port: int) -> dict:
    """(c) A ray:// driver in a subprocess: an ActorPool of two num_gpus=0.5
    actors, each GPT-2 small f32 on the card from one seed, maps 8 batches
    of [4, 512] prompts; every logit and greedy id equals this process's
    forward on the same card, B1 launched 12 x 8 times (counts through a
    util.queue.Queue the client drains), the client without torch, and
    after it disconnects its actors are DEAD, the GPU back and the pool's
    tasks in state.timeline()."""
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch.util import state

    deadline = time.monotonic() + 30
    while True:  # the head spawned the client server at init(): wait for it to listen
        try:
            rpc.RpcClient(f"tcp:127.0.0.1:{port}").close()
            break
        except rpc.RpcError:  # not listening yet
            if time.monotonic() > deadline:
                raise AssertionError(f"the head's client server never listened on {port}")
            time.sleep(0.2)
    deadline = time.monotonic() + 60  # (b)'s worker gives its lease back
    while ray_tpu_torch.available_resources().get("GPU", 0.0) != 1.0:
        if time.monotonic() > deadline:
            raise AssertionError(f"the GPU never came back after fit(): "
                                 f"{ray_tpu_torch.available_resources()}")
        time.sleep(0.1)
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_client_") as tmp:
        script = os.path.join(tmp, "client.py")
        with open(script, "w") as f:
            f.write(_CLIENT_SCRIPT)
        env = {k: v for k, v in os.environ.items() if not k.startswith("RAY_TPU_TORCH_")}
        env["PYTHONPATH"] = repo
        proc = subprocess.Popen(
            [sys.executable, script, f"ray://127.0.0.1:{port}", tmp,
             *(str(x) for x in (CLIENT_B, CLIENT_T, CLIENT_BATCHES, CLIENT_SEED, PROMPT_VOCAB))],
            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            # this process's reference meanwhile: the same model and batches
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            cfg = gpt2.GPT2Config.small(dtype=torch.float32, remat=False)
            model = gpt2.init_model(cfg, torch.Generator().manual_seed(CLIENT_SEED),
                                    device="cpu").to("cuda").eval()
            batches = [np.random.default_rng(200 + i).integers(0, PROMPT_VOCAB,
                                                               size=(CLIENT_B, CLIENT_T))
                       for i in range(CLIENT_BATCHES)]
            with torch.inference_mode():
                want = [model(torch.from_numpy(b).to("cuda"))[:, -1] for b in batches]
                want_ids = [w.argmax(-1).cpu().numpy() for w in want]
                want = [w.cpu().numpy() for w in want]
            del model
            torch.cuda.empty_cache()
            # the client's results, while it stays connected
            deadline = time.monotonic() + 600
            while not os.path.exists(os.path.join(tmp, "summary.json")):
                if proc.poll() is not None or time.monotonic() > deadline:
                    out = proc.communicate(timeout=30)[0] if proc.poll() is not None else ""
                    raise AssertionError(f"the ray:// client ended ({proc.returncode}) "
                                         f"without its results: {out[-4000:]}")
                time.sleep(0.1)
            with open(os.path.join(tmp, "summary.json")) as f:
                summary = json.load(f)
            ids_hex = set(summary["actor_ids"])
            # the pool's tasks in state.timeline(), its actors still alive
            path = os.path.join(tmp, "timeline.json")
            deadline = time.monotonic() + 20
            while True:
                with open(state.timeline(path)) as f:
                    events = json.load(f)
                pool_events = [e for e in events if e.get("name") == "forward"
                               and (e.get("args") or {}).get("actor_id") in ids_hex]
                if len(pool_events) >= 2 * CLIENT_BATCHES or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            with open(os.path.join(tmp, "release"), "w"):
                pass
            out, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"the ray:// client failed ({proc.returncode}): {out[-4000:]}")
        got = np.load(os.path.join(tmp, "out.npz"))
        logits, ids, u_logits, u_ids = (got[k] for k in ("logits", "ids", "u_logits", "u_ids"))
    bad = [i for i in range(CLIENT_BATCHES)
           if not (np.array_equal(logits[i], want[i]) and np.array_equal(ids[i], want_ids[i]))]
    err = float(max(np.abs(logits[i].astype(np.float64) - want[i]).max()
                    for i in range(CLIENT_BATCHES)))
    keys = sorted(logits[i].tobytes() + ids[i].tobytes() for i in range(CLIENT_BATCHES))
    u_keys = sorted(u_logits[i].tobytes() + u_ids[i].tobytes() for i in range(CLIENT_BATCHES))
    same_set = keys == u_keys
    want_launches = cfg.n_layer * CLIENT_BATCHES
    # after the disconnect: the client's actors die with its connection and
    # the card's GPU goes back
    deadline, states = time.monotonic() + 30, {}
    while True:
        states = {a["actor_id"]: a["state"] for a in state.list_actors()
                  if a["actor_id"] in ids_hex}
        gpu = ray_tpu_torch.available_resources().get("GPU", 0.0)
        if (len(states) == 2 and set(states.values()) == {"DEAD"} and gpu == 1.0) or (
                time.monotonic() > deadline):
            break
        time.sleep(0.2)
    res = {**summary, "bad": bad, "max_abs_diff": err, "unordered_same_set": same_set,
           "actor_states": states, "gpu_after": gpu, "timeline_pool_events": len(pool_events),
           "timeline_events": len(events),
           # this process's forward of batch 0, which phase 23's workflow holds its step to
           "batch0": (want[0], want_ids[0])}
    print(f"[runtime] ray:// client (pid {summary['pid']}, connected in "
          f"{summary['connect_s']:.2f} s): ActorPool of two num_gpus=0.5 actors (pids "
          f"{summary['actor_pids']}, GPT-2 small f32 on the card, ready in "
          f"{summary['actors_ready_s']:.2f} s), pool.map over {CLIENT_BATCHES} batches of "
          f"[{CLIENT_B}, {CLIENT_T}] in {summary['map_s']:.2f} s: batches differing from this "
          f"process's forward {bad} (max |diff| {err:.3e}, want 0), map_unordered the same set "
          f"{same_set}; B1 launches through the queue {sum(summary['launches'])} (want "
          f"{want_launches}) and {sum(summary['launches_unordered'])} unordered; the client maps "
          f"libtorch {summary['libtorch']}, libcuda {summary['libcuda']}; after it disconnected "
          f"its actors {sorted(states.values())}, GPU free {gpu}; state.timeline() holds "
          f"{len(pool_events)} of the pool's forward events — {card}", flush=True)
    if bad or err != 0.0 or not same_set:
        raise AssertionError(f"the pool's logits differ from the driver's forward: {bad}, {err}")
    if (sum(summary["launches"]) != want_launches
            or sum(summary["launches_unordered"]) != want_launches):
        raise AssertionError(f"B1 launched {summary['launches']} / "
                             f"{summary['launches_unordered']}, want {want_launches} each")
    if summary["libtorch"] or summary["libcuda"] or summary["torch_imported"]:
        raise AssertionError(f"the ray:// client loaded torch or CUDA: {summary}")
    if len(states) != 2 or set(states.values()) != {"DEAD"} or gpu != 1.0:
        raise AssertionError(f"the client's actors outlived it: {states}, GPU {gpu}")
    if len(pool_events) < 2 * CLIENT_BATCHES:
        raise AssertionError(f"state.timeline() holds {len(pool_events)} of the pool's "
                             f"{2 * CLIENT_BATCHES} forward tasks")
    return res


@ray_tpu_torch.remote(num_gpus=1)
class GPT2StepActor:
    """A GPU actor that takes one float32 AdamW step of GPT-2 small, as
    phase 8's card step does."""

    def step(self, seed: int, tokens, lr: float):
        import os

        import torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.ops import flash_attention as fa

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = gpt2.GPT2Config.small(dtype=torch.float32, remat=False)
        model = gpt2.init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
        model = model.to("cuda")
        step = gpt2.make_train_step(cfg, gpt2.make_adamw(model.parameters(), lr))
        toks = torch.tensor(tokens).to("cuda")  # a copy: the arg is read-only
        fa.flash_attention_fwd.launches = 0
        fa.flash_attention_dq.launches = 0
        fa.flash_attention_dkv.launches = 0
        loss = step(model, toks[:, :-1], toks[:, 1:])
        torch.cuda.synchronize()
        launches = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
                    fa.flash_attention_dkv.launches)
        return {"loss": loss, "launches": launches, "pid": os.getpid(),
                "device": torch.cuda.get_device_name(0)}


_DETECT_SCRIPT = r"""
import json, sys, time
from ray_tpu_torch._private.accelerators import get_accelerator_manager
from ray_tpu_torch._private.node import detect_resources
G = get_accelerator_manager("GPU")
# a node start's detection: the first in a process reads the cards' names,
# a later one finds them cached
t0 = time.perf_counter()
detect_resources(num_cpus=4)
t1 = time.perf_counter()
detect_resources(num_cpus=4)
t2 = time.perf_counter()
out = {"detect_first_s": t1 - t0, "detect_later_s": t2 - t1,
       "cards": G.get_current_node_num_accelerators(),
       "type": G.get_current_node_accelerator_type(),
       "additional": G.get_current_node_additional_resources(),
       "torch": sorted(m for m in sys.modules if m.split(".")[0] == "torch")}
with open("/proc/self/maps") as f:
    maps = f.read()
out.update(uvm="/dev/nvidia-uvm" in maps, libcuda="libcuda" in maps)
print(json.dumps(out))
"""


def _card_type_checks(card: str, resources: dict) -> dict:
    """(25 a) The head's card type and slice resources: a clean process that
    imports no torch detects one card of type <family>-1, the family that of
    torch's name for the card, and maps no /dev/nvidia-uvm (no CUDA
    context); the head's cluster_resources() show that type's GPU-<type>
    and GPU-<type>-head at 1.0."""
    from ray_tpu_torch._private.accelerators.gpu import family_of

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", _DETECT_SCRIPT], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise AssertionError(f"detection in a clean process failed: {proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    name = torch.cuda.get_device_name(0)
    want = f"{family_of(name)}-1"
    got.update(torch_name=name, want_type=want, seconds=time.perf_counter() - t0,
               head={k: v for k, v in resources.items() if k.startswith("GPU")})
    print(f"[runtime] the card's type (25 a): a clean process detects {got['cards']} card(s) of "
          f"type {got['type']} (torch names the card {name!r}: {want}), additional resources "
          f"{got['additional']}, torch modules {got['torch']}, /dev/nvidia-uvm mapped "
          f"{got['uvm']}, libcuda mapped {got['libcuda']}, in {got['seconds']:.2f} s; "
          f"detect_resources() {got['detect_first_s']:.4f} s the first time in that process, "
          f"{got['detect_later_s']:.4f} s the next (the cards' names cached); the head's GPU "
          f"resources {got['head']} — {card}", flush=True)
    if (got["cards"] != 1 or got["type"] != want or got["torch"] or got["uvm"]
            or got["additional"] != {f"GPU-{want}": 1.0, f"GPU-{want}-head": 1.0}):
        raise AssertionError(f"the card's detection: {got}")
    if (resources.get(f"GPU-{want}") != 1.0 or resources.get(f"GPU-{want}-head") != 1.0):
        raise AssertionError(f"the head does not show GPU-{want} and GPU-{want}-head: "
                             f"{resources}")
    return got


def phase_runtime(card: str, parity: dict, raw: dict) -> dict:
    """The port's runtime on the card.  ``parity`` is phase 8's result (the
    driver's own f32 step), ``raw`` phase 9's (the raw training path)."""
    torch.cuda.empty_cache()  # the earlier phases' cached blocks go back to the card
    t0 = time.perf_counter()
    # (c)'s ray:// endpoint: the head spawns the client server on this port
    client_port = _free_port()
    os.environ[_CLIENT_PORT_ENV] = str(client_port)
    try:
        ctx = ray_tpu_torch.init(num_cpus=4)
    finally:
        os.environ.pop(_CLIENT_PORT_ENV)
    res = {"session_dir": ctx["session_dir"], "card": card, "client_port": client_port}
    try:
        resources = ray_tpu_torch.cluster_resources()
        res["cluster_gpus"] = resources.get("GPU")
        if resources.get("GPU") != 1.0 or torch.cuda.device_count() != 1:
            raise AssertionError(f"the raylet counts GPU {resources.get('GPU')} on a machine "
                                 f"with {torch.cuda.device_count()} card(s): {resources}")
        res["detected"] = _card_type_checks(card, resources)
        runtime_pids = set(_port_processes())

        # (a) a num_gpus=1 actor: phase 8's step, its loss back through the
        # object store
        tokens = np.random.default_rng(3).integers(0, PROMPT_VOCAB, size=(2, 129))
        actor = GPT2StepActor.remote()
        out = ray_tpu_torch.get(actor.step.remote(0, tokens, TRAIN_LR), timeout=600)
        loss = out["loss"]
        if not (isinstance(loss, torch.Tensor) and loss.device.type == "cpu"):
            raise AssertionError(f"the actor's loss arrived as {type(loss)} on "
                                 f"{getattr(loss, 'device', None)}, expected a CPU tensor")
        rel = abs(loss.item() - parity["loss_cuda"]) / abs(parity["loss_cuda"])
        want = (12, 12, 12)
        # no runtime process but the worker holds the CUDA driver: the GCS
        # and the raylet share the head process; the worker, alive here,
        # is the check's positive control.  The maps decide: in a
        # container nvidia-smi lists pids of another namespace
        smi_pids = _compute_app_pids()
        head = [pid for pid, cmd in _port_processes().items() if "head_main" in cmd]
        with_cuda = sorted(pid for pid in runtime_pids | {out["pid"]} if _maps_libcuda(pid))
        res["actor"] = {"loss": loss.item(), "driver_loss": parity["loss_cuda"],
                        "loss_rel_err": rel, "launches": list(out["launches"]),
                        "device": out["device"], "worker_pid": out["pid"], "head_pids": head,
                        "compute_app_pids": sorted(smi_pids),
                        "runtime_pids_with_libcuda": with_cuda}
        print(f"[runtime] init(num_cpus=4): cluster GPU {resources['GPU']}; head pid(s) {head}, "
              f"runtime processes with the CUDA driver mapped {with_cuda} (worker {out['pid']}), "
              f"nvidia-smi compute apps {sorted(smi_pids)} — {card}", flush=True)
        print(f"[runtime] num_gpus=1 actor on {out['device']}: GPT-2 small f32 one AdamW step, "
              f"loss {loss.item():.6f} (a CPU tensor through the object store) vs the driver's "
              f"{parity['loss_cuda']:.6f} (rel {rel:.2e}, tol 1e-4); launches B1/B2/B3 "
              f"{tuple(out['launches'])} (want {want}) — {card}", flush=True)
        if rel > 1e-4 or tuple(out["launches"]) != want:
            raise AssertionError(f"the GPU actor's step disagrees: {res['actor']}")
        if not head or set(head) & smi_pids or with_cuda != [out["pid"]]:
            raise AssertionError(f"a runtime process other than the GPU worker holds CUDA: "
                                 f"{res['actor']}")
        ray_tpu_torch.kill(actor)

        # (b) the training path inside TorchTrainer.fit() on one GPU worker,
        # profiled from a thread of the driver through util.state while it
        # steps (PROFILED_STEPS timed steps, so the capture ends inside them)
        cfg = gpt2.GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.float32, remat=False)
        toks = np.random.default_rng(4).integers(0, PROMPT_VOCAB, size=(TRAIN_B, TRAIN_T + 1))
        _reset_counts()  # the driver's counts: they must stay 0 while the worker trains
        t_b = time.perf_counter()
        profiler = _Background(_profile_trainer)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as storage:
            result = TorchTrainer(
                train_loop_per_worker,
                train_loop_config={"cfg": cfg, "seed": 0, "tokens": toks, "lr": TRAIN_LR,
                                   "warmup": TRAIN_WARMUP, "steps": PROFILED_STEPS,
                                   "device": "cuda", "peak_flops": PEAK_BF16_FLOPS},
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                run_config=RunConfig(name="gpt2_in_framework", storage_path=storage),
            ).fit()
        prof = profiler.join(timeout=120)
        m = result.metrics
        n_steps = TRAIN_WARMUP + PROFILED_STEPS
        want = [cfg.n_layer * n_steps] * 3
        losses = m["losses"]
        res["trainer"] = {**m, "raw_step_ms": raw["step_ms"], "raw_losses": raw["losses"],
                          "driver_launches": list(_launch_counts())}
        res["trainer_profile"] = _hold_trainer_profile(card, prof, m)
        print(f"[runtime] TorchTrainer.fit(), ScalingConfig(num_workers=1, use_gpu=True), GPT-2 "
              f"small bf16 compute / f32 params, B={TRAIN_B} T={TRAIN_T}, on "
              f"{m.get('device_name')}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{n_steps} steps; in-framework step {m['step_ms']:.2f} ms over {PROFILED_STEPS} "
              f"timed steps, {prof['timed_overlap_s']:.2f} s of their "
              f"{prof['timed_window_s']:.2f} s under the sampler, beside the raw step "
              f"{raw['step_ms']:.2f} ms (phase 9, this run), {m['tokens_per_s']:.0f} tok/s, "
              f"MFU {m['mfu']:.4f}; launches inside the worker B1/B2/B3 {m['launches']} = "
              f"{cfg.n_layer} x {n_steps}, the driver's {tuple(_launch_counts())} — {card}",
              flush=True)
        if m["launches"] != want:
            raise AssertionError(f"the worker launched (B1, B2, B3) {m['launches']}, want {want}")
        if _launch_counts() != (0, 0, 0):
            raise AssertionError("the driver's counts moved during fit(): the step ran here")
        if not (m["finite"] and losses[-1] < losses[0]):
            raise AssertionError(f"in-framework loss not finite and falling: {losses}")
        # the same weights (seed 0), batch, optimizer and steps as phase 9:
        # every step is the same bf16 computation in another process, so
        # every loss of phase 9's steps, not only the first, holds the
        # update to the raw run's (the later, profiled steps have no raw twin)
        rels = [abs(a - b) / abs(b) for a, b in zip(losses, raw["losses"])]
        res["trainer"]["loss_rel_err_vs_raw"] = max(rels)
        print(f"[runtime] losses {losses[0]:.6f} ... {losses[len(rels) - 1]:.6f} vs phase 9's "
              f"{raw['losses'][0]:.6f} ... {raw['losses'][-1]:.6f} on the same weights and batch: "
              f"max rel {max(rels):.2e} over the first {len(rels)} steps (tol 1e-5)", flush=True)
        if (len(raw["losses"]) != TRAIN_WARMUP + TRAIN_STEPS or len(losses) != n_steps
                or max(rels) > 1e-5):
            raise AssertionError(f"in-framework losses {losses} != raw {raw['losses']}")
        print(f"[timing] runtime (b) profiled fit: {time.perf_counter() - t_b:.1f} s", flush=True)

        # (c) Ray Client: a ray:// driver in a process without torch runs an
        # ActorPool of two half-card GPT-2 actors
        t_c = time.perf_counter()
        res["client"] = _client_pool(card, client_port)
        batch0 = res["client"].pop("batch0")
        print(f"[timing] runtime (c) ray:// client pool: {time.perf_counter() - t_c:.1f} s",
              flush=True)
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 20
    left = _port_processes()
    while left and time.monotonic() < deadline:
        time.sleep(0.5)
        left = _port_processes()
    res["processes_left"] = left
    res["seconds"] = time.perf_counter() - t0
    print(f"[runtime] shutdown(): port processes left {sorted(left)}; phase took "
          f"{res['seconds']:.1f} s", flush=True)
    if left:
        raise AssertionError(f"port processes still running after shutdown(): {left}")
    print("[runtime] " + json.dumps(res), flush=True)
    res["client_batch0"] = batch0
    return res


# ----------------------------------------------------------------------
# The serve control plane: serve.run(llm.build_app(cfg)) behind the HTTP proxy,
# the replica on the card
# ----------------------------------------------------------------------
# the static batch: a prompt near max_seq_len with few tokens beside short
# prompts with many, so the lockstep decode runs its lane past max_seq_len
STATIC_LENS = (1000, 20, 300, 100)
STATIC_MAX_TOKENS = (8, 64, 24, 40)


class _ReplicaLaunches:
    """B1's launch count in the replica's own process (counts are per
    process), reset and read through actor calls on the replica; and what
    the replica served: the streams its LLMServer answered by any route,
    and the calls, streams and stream items its channel dataplane carried
    (``dataplane.SERVED``)."""

    def reset_launches(self) -> int:
        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.serve._private import dataplane

        fa.flash_attention_fwd.launches = 0
        for key in dataplane.SERVED:
            dataplane.SERVED[key] = 0
        self.streams_answered = 0
        return 0

    def launches(self) -> int:
        from ray_tpu_torch.ops import flash_attention as fa

        return fa.flash_attention_fwd.launches

    def served(self) -> dict:
        from ray_tpu_torch.serve._private import dataplane

        return {"streams_answered": getattr(self, "streams_answered", 0),
                "dataplane": dict(dataplane.SERVED)}


class CountingLLMServer(_ReplicaLaunches, LLMServer):
    """LLMServer plus its replica's B1 count and served streams (a class of
    __main__, so the runtime pickles it by value: the controller imports
    only the port's deployment module, which loads no torch)."""

    async def __call__(self, payload):
        import inspect

        out = await super().__call__(payload)
        if inspect.isasyncgen(out):  # an HTTP stream, whatever carried it here
            self.streams_answered = getattr(self, "streams_answered", 0) + 1
        return out


class CountingStaticServer(_ReplicaLaunches, StaticBatchLLMServer):
    """StaticBatchLLMServer plus its replica's B1 count."""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_route(port: int, prefix: str, timeout_s: float = 60.0) -> None:
    import urllib.request

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/routes", timeout=5) as r:
                if prefix in json.loads(r.read()):
                    return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"the proxy never routed {prefix}")


def _http_call(port: int, path: str, payload: dict, stream: bool) -> dict:
    """One request through the proxy with the stdlib client.  A stream
    (x-serve-stream: 1) is read line by line as the chunks arrive: its
    token ids, its last event, and the seconds to the first token."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        headers = {"Content-Type": "application/json"}
        if stream:
            headers["x-serve-stream"] = "1"
        conn.request("POST", path, body=json.dumps(payload), headers=headers)
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"POST {path}: HTTP {resp.status} {resp.read()[:300]!r}")
        if not stream:
            out = json.loads(resp.read())
            out["t_end"] = time.perf_counter()
            return out
        tokens, last, ttft = [], None, None
        for line in resp:
            if not line.strip():
                continue
            ev = json.loads(line)
            if "token" in ev:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                tokens.append(ev["token"])
            elif ev.get("done"):
                last = ev
        if last is None:
            raise AssertionError(f"POST {path}: the stream ended without its summary event")
        return {"tokens": tokens, "finish_reason": last["finish_reason"],
                "num_tokens": last["num_tokens"], "ttft_s": ttft, "t_end": time.perf_counter()}
    finally:
        conn.close()


def _http_concurrent(port: int, path: str, payloads: list, stream: bool) -> list:
    """All payloads at once, one client thread and connection each."""
    import threading

    results, errors = [None] * len(payloads), []

    def run(i):
        try:
            results[i] = _http_call(port, path, payloads[i], stream)
        except Exception as e:  # noqa: BLE001 — raised below, with the others
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(r is None for r in results):
        raise AssertionError(f"HTTP requests to {path} failed: {errors or 'timed out'}")
    return results


def _serve_actor_pids() -> dict:
    """name -> pid of every live actor of the serve namespace, from the
    GCS's actor table."""
    from ray_tpu_torch._private.worker import global_worker_maybe

    actors = global_worker_maybe().gcs_client.call("list_actors", None)
    return {a["name"]: a["pid"] for a in actors
            if a["namespace"] == "serve" and a["state"] == "ALIVE" and a["name"]}


def _maps_lib(pid: int, lib: str) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return lib in f.read()


def _build_app(cfg: LLMConfig, cls=None, *args):
    """``llm.build_app(cfg)`` on a route named after ``cfg``.  With ``cls``,
    the same deployment (build_app's settings, and the GPU its replica
    leases for an engine on the card) serves ``cls`` bound to ``args``
    instead of LLMServer: a counting subclass the card's run reads."""
    app = rt_llm.build_app(cfg, route_prefix=f"/{cfg.name}")
    if cls is None:
        return app
    return rt_serve.Deployment(cls, app.deployment._config).bind(*args)


def _serve_references() -> dict:
    """Phase 6's mix and the static batch, with their references made in
    this process on this card: the f32 engine's tokens over the mix and
    the static server's over its batch.  Phase 16 makes them, phase 17
    reuses them."""
    cfg_bf16, prompts, max_tokens = _serve_mix()
    cfg_bf16 = dataclasses.replace(cfg_bf16, name="llm_bf16")
    cfg_f32 = dataclasses.replace(cfg_bf16, dtype="float32", name="llm_f32")
    rng = np.random.default_rng(5)
    static_specs = [{"prompt": rng.integers(0, PROMPT_VOCAB, size=n).tolist(), "max_tokens": m}
                    for n, m in zip(STATIC_LENS, STATIC_MAX_TOKENS)]
    static_cfg = dataclasses.replace(cfg_f32, max_batch_size=len(static_specs),
                                     name="llm_static")

    async def engine_run():
        eng = LLMEngine(cfg_f32)
        reqs = [await eng.add_request(p, max_tokens=m) for p, m in zip(prompts, max_tokens)]
        outs = await asyncio.gather(*[_drain(r) for r in reqs])
        await eng.stop()
        return outs

    refs = {
        "cfg_bf16": cfg_bf16, "cfg_f32": cfg_f32, "static_cfg": static_cfg,
        "prompts": prompts, "max_tokens": max_tokens, "static_specs": static_specs,
        "mix": [{"prompt": p, "max_tokens": m} for p, m in zip(prompts, max_tokens)],
        "n_layer": cfg_bf16.model_config().n_layer,
        "want_f32": asyncio.run(engine_run()),
        "want_static": StaticBatchLLMServer(static_cfg)._run_batch(static_specs),
    }
    torch.cuda.empty_cache()  # the replicas get the card
    return refs


def _serve_http(tag: str, card: str, engine_serve: dict, refs: dict, port: int,
                while_f32=None, control=("SERVE_CONTROLLER", "SERVE_PROXY"),
                while_bf16=None) -> dict:
    """Phase 6's traffic through serve.run(llm.build_app(cfg)) and the HTTP
    proxy of a running serve instance: (a) the f32 mix as 16 concurrent
    chunked streams and one static batch, each against ``refs``; (b) the
    bf16 mix against phase 6's tokens (``engine_serve``), with the
    replica's B1 launches, KV pool and served streams read in the
    replica; (c) which processes map libcuda and libtorch.  ``while_f32``
    runs while the f32 deployment still serves, ``while_bf16`` on a thread
    of its own beside the bf16 mix (its result joins ``res``)."""
    mix, max_tokens, n_layer = refs["mix"], refs["max_tokens"], refs["n_layer"]
    cfg_bf16, cfg_f32, static_cfg = refs["cfg_bf16"], refs["cfg_f32"], refs["static_cfg"]
    res = {}

    # (a) f32 greedy parity over HTTP: 16 concurrent chunked streams
    rt_serve.run(_build_app(cfg_f32), name="llm_f32_app", http_port=port)
    _wait_route(port, "/llm_f32")
    res["gpu_free_with_replica"] = ray_tpu_torch.available_resources().get("GPU", 0.0)
    if res["gpu_free_with_replica"] != 0.0:
        raise AssertionError(f"the replica did not lease the card's GPU: "
                             f"{ray_tpu_torch.available_resources()}")
    got = _http_concurrent(port, "/llm_f32", mix, stream=True)
    bad = [i for i, (g, w) in enumerate(zip(got, refs["want_f32"])) if g["tokens"] != w]
    print(f"[{tag}] f32 GPT-2 small, serve.run(llm.build_app(cfg)) (cluster "
          f"GPU left {res['gpu_free_with_replica']}): {len(mix)} concurrent HTTP streams, "
          f"{sum(len(g['tokens']) for g in got)} greedy tokens, requests differing from the "
          f"LLMEngine in this process: {bad} — {card}", flush=True)
    if bad:
        raise AssertionError(f"f32 HTTP tokens differ from this process's engine at {bad}")
    if while_f32 is not None:
        res.update(while_f32())
    rt_serve.delete("llm_f32")

    # (a) the static-batch server: one batch of 4, its long lane past
    # max_seq_len, against this process's static server
    static_specs = refs["static_specs"]
    shandle = rt_serve.run(
        _build_app(static_cfg, CountingStaticServer, static_cfg.to_dict(), 5.0),
        name="llm_static_app", http_port=port)
    _wait_route(port, "/llm_static")
    shandle.reset_launches.remote().result(timeout=120)
    sgot = _http_concurrent(port, "/llm_static", static_specs, stream=False)
    res["static_launches"] = shandle.launches.remote().result(timeout=120)
    sbad = [i for i, (g, w) in enumerate(zip(sgot, refs["want_static"]))
            if g["tokens"] != w["tokens"] or g["num_tokens"] != STATIC_MAX_TOKENS[i]]
    print(f"[{tag}] StaticBatchLLMServer f32, one batch of prompts {STATIC_LENS} x "
          f"max_tokens {STATIC_MAX_TOKENS} over HTTP (lane 0 decodes to position "
          f"{STATIC_LENS[0] + max(STATIC_MAX_TOKENS) - 1} > max_seq_len "
          f"{static_cfg.model_config().max_seq_len}): lanes differing from this process's "
          f"static server {sbad}; B1 launches in the replica {res['static_launches']} "
          f"(want {n_layer}: one batched prefill) — {card}", flush=True)
    if sbad or res["static_launches"] != n_layer:
        raise AssertionError(f"static batch: lanes {sbad} differ, or B1 launched "
                             f"{res['static_launches']} times (want {n_layer})")
    rt_serve.delete("llm_static")

    # (b) the bf16 serving mix over HTTP
    handle = rt_serve.run(_build_app(cfg_bf16, CountingLLMServer, cfg_bf16.to_dict()),
                          name="llm_bf16_app", http_port=port)
    _wait_route(port, "/llm_bf16")
    _http_call(port, "/llm_bf16", {"prompt": [1, 2, 3], "max_tokens": 2}, stream=True)
    handle.reset_launches.remote().result(timeout=120)
    beside = _Background(while_bf16) if while_bf16 is not None else None
    t_start = time.perf_counter()
    got = _http_concurrent(port, "/llm_bf16", mix, stream=True)
    wall = max(g["t_end"] for g in got) - t_start
    if beside is not None:
        res.update(beside.join(timeout=120))
    launches = handle.launches.remote().result(timeout=120)
    served = handle.served.remote().result(timeout=120)
    for i, g in enumerate(got):
        if g["finish_reason"] != "length" or len(g["tokens"]) != max_tokens[i]:
            raise AssertionError(f"bf16 request {i} ended {g['finish_reason']} after "
                                 f"{len(g['tokens'])}/{max_tokens[i]} tokens")
    deadline = time.monotonic() + 30
    stats = handle.stats.remote().result(timeout=120)
    while time.monotonic() < deadline and (stats["kv_leak_report"]["blocks_in_use"]
                                           or stats["kv_leak_report"]["live_sequences"]):
        time.sleep(0.2)
        stats = handle.stats.remote().result(timeout=120)
    leak = stats["kv_leak_report"]
    ttft = [g["ttft_s"] for g in got]
    total = sum(len(g["tokens"]) for g in got)
    same = sum(a == b for g, w in zip(got, engine_serve["tokens"])
               for a, b in zip(g["tokens"], w))
    res.update({
        "requests": len(got), "launches": launches, "kv_leak_report": leak, "served": served,
        "tokens": total,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p95_s": float(np.percentile(ttft, 95)),
        "decode_tok_per_s": (total - len(got)) / wall, "wall_s": wall,
        "engine_ttft_p50_s": engine_serve["ttft_p50_s"],
        "engine_ttft_p95_s": engine_serve["ttft_p95_s"],
        "engine_decode_tok_per_s": engine_serve["decode_tok_per_s"],
        "engine_wall_s": engine_serve["wall_s"],
        "bf16_tokens_equal_to_phase6": same / total,
    })
    print(f"[{tag}] bf16 GPT-2 small over HTTP, {len(got)} concurrent streams: "
          f"client TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{res['ttft_p95_s'] * 1e3:.1f} ms, decode {res['decode_tok_per_s']:.1f} tok/s, "
          f"wall {wall:.2f} s; phase 6's engine in this run: TTFT p50 "
          f"{engine_serve['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{engine_serve['ttft_p95_s'] * 1e3:.1f} ms, decode "
          f"{engine_serve['decode_tok_per_s']:.1f} tok/s, wall {engine_serve['wall_s']:.2f} s; "
          f"B1 launches in the replica {launches} (want {n_layer} x {len(got)}); KV blocks "
          f"in use {leak['blocks_in_use']}, live sequences {leak['live_sequences']}; share "
          f"of tokens equal to phase 6's {same / total:.4f} (want 1); served in the replica "
          f"{json.dumps(served)} — {card}", flush=True)
    if launches != n_layer * len(got):
        raise AssertionError(f"B1 launched {launches} times in the replica, "
                             f"want {n_layer} x {len(got)}")
    if leak["blocks_in_use"] or leak["live_sequences"]:
        raise AssertionError(f"KV leak in the replica after the mix drained: {leak}")
    # the engine's rows do not depend on the other lanes (fixed shapes,
    # one prefill a request), so a different arrival order over HTTP
    # leaves every bf16 token as phase 6 made it on this card
    if same != total:
        raise AssertionError(f"bf16 tokens over HTTP differ from phase 6's: "
                             f"{same}/{total} equal")
    if served["streams_answered"] != len(got):
        raise AssertionError(f"the replica answered {served['streams_answered']} streams, "
                             f"want {len(got)}")

    # (c) process boundaries: only the replica maps libcuda;
    # the control processes never load torch (the maps decide)
    pids = _serve_actor_pids()
    replica = [pid for name, pid in pids.items()
               if name.startswith("SERVE_REPLICA::llm_bf16#")]
    control = {name: pids.get(name) for name in control}
    res["processes"] = {
        name: {"pid": pid, "libcuda": _maps_lib(pid, "libcuda"),
               "libtorch": _maps_lib(pid, "libtorch")}
        for name, pid in [*control.items(), *(("replica", p) for p in replica)] if pid
    }
    print(f"[{tag}] processes: {json.dumps(res['processes'])}", flush=True)
    if (len(replica) != 1 or None in control.values()
            or not res["processes"]["replica"]["libcuda"]
            or any(res["processes"][n]["libcuda"] or res["processes"][n]["libtorch"]
                   for n in control)):
        raise AssertionError(f"process boundaries broken: {res['processes']}")
    return res


_RING_PREFIXES = ("ray_tpu_torch_serve_", "ray_tpu_torch_dag_", "ray_tpu_torch_pp",
                  "ray_tpu_torch_rllib_")


def _ring_dirs() -> list:
    """The port's channel ring directories left under the ring base."""
    from ray_tpu_torch.experimental.channel import ring_base_dir

    base = ring_base_dir()
    return sorted(n for n in os.listdir(base) if n.startswith(_RING_PREFIXES))


def _shut_down(tag: str, res: dict, t0: float) -> None:
    """After serve.shutdown() and shutdown(): no port process is left (and
    no ring directory of the port's channels)."""
    deadline = time.monotonic() + 20
    left, rings = _port_processes(), _ring_dirs()
    while (left or rings) and time.monotonic() < deadline:
        time.sleep(0.5)
        left, rings = _port_processes(), _ring_dirs()
    res["processes_left"], res["ring_dirs_left"] = left, rings
    res["seconds"] = time.perf_counter() - t0
    print(f"[{tag}] serve.shutdown(), shutdown(): port processes left {sorted(left)}, "
          f"ring directories left {rings}; phase took {res['seconds']:.1f} s", flush=True)
    if left or rings:
        raise AssertionError(f"left after shutdown(): processes {left}, ring dirs {rings}")


_DATAPLANE_ENV = "RAY_TPU_TORCH_serve_channel_dataplane"


def phase_serve_plane(card: str, engine_serve: dict) -> dict:
    """Phase 6's traffic through serve.run(llm.build_app(cfg)) and the HTTP
    proxy on the routers' actor-RPC path: ``serve_channel_dataplane`` is
    off for this cluster (its processes inherit the setting), and the
    replica's dataplane serves nothing.  ``engine_serve`` is phase 6's
    result: its bf16 tokens and metrics."""
    t0 = time.perf_counter()
    refs = _serve_references()
    port = _free_port()
    saved = os.environ.get(_DATAPLANE_ENV)
    os.environ[_DATAPLANE_ENV] = "0"
    try:
        ctx = ray_tpu_torch.init(num_cpus=4)
        res = {"session_dir": ctx["session_dir"], "card": card, "http_port": port}
        try:
            rt_serve.start(http_port=port)
            res.update(_serve_http("serve plane", card, engine_serve, refs, port))
        finally:
            try:
                rt_serve.shutdown()
            finally:
                ray_tpu_torch.shutdown()
    finally:
        if saved is None:
            os.environ.pop(_DATAPLANE_ENV, None)
        else:
            os.environ[_DATAPLANE_ENV] = saved
    dp = res["served"]["dataplane"]
    print(f"[serve plane] transport: {_DATAPLANE_ENV}=0, the replica's dataplane served "
          f"{json.dumps(dp)} (want all 0: every request took actor RPC)", flush=True)
    if any(dp.values()):
        raise AssertionError(f"the RPC phase's replica served over its dataplane: {dp}")
    _shut_down("serve plane", res, t0)
    print("[serve plane] " + json.dumps(res), flush=True)
    res["refs"] = refs  # for phase 17; not printed
    return res


# the compiled DAG's input: [4, 1000] prompt tokens, 8 executions
DAG_B, DAG_T, DAG_EXECUTIONS = 4, 1000, 8


class Prefill:
    """The DAG's GPU stage: GPT-2 small in float32 on its card, the
    forward over the prompts with the attention through B1, and the
    last position's logits returned as a CUDA tensor."""

    def __init__(self, seed: int):
        import torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.train.torch.gpt2_loop import worker_device

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the op loop runs in a thread of its own: the card is named, not
        # taken from the thread's current device
        self.device = worker_device("cuda", 0)
        cfg = gpt2.GPT2Config.small(dtype=torch.float32, remat=False)
        self.model = gpt2.init_model(cfg, torch.Generator().manual_seed(seed),
                                     device="cpu").to(self.device).eval()

    def forward(self, tokens):
        import torch

        with torch.inference_mode():
            # a copy of the last position: the [4, T, vocab] logits go
            return self.model(torch.from_numpy(tokens).to(self.device))[:, -1].contiguous()

    def reset_launches(self) -> int:
        from ray_tpu_torch.ops import flash_attention as fa

        fa.flash_attention_fwd.launches = 0
        return 0

    def launches(self) -> int:
        from ray_tpu_torch.ops import flash_attention as fa

        return fa.flash_attention_fwd.launches


class Argmax:
    """The DAG's CPU stage: the greedy ids of the logits it receives."""

    def pick(self, logits):
        return logits.argmax(-1).tolist()

    def cuda_state(self) -> dict:
        """Whether torch made a CUDA context here; and, for the record,
        whether the driver library is mapped (torch's CUDA build loads it
        to ask for the device count without making a context)."""
        import os

        import torch

        with open(f"/proc/{os.getpid()}/maps") as f:
            maps = f.read()
        return {"cuda_initialized": torch.cuda.is_initialized(), "libcuda": "libcuda" in maps}


def _dag_gpu_stage(card: str) -> dict:
    """(c) A compiled DAG whose first stage is a num_gpus=1 actor running
    GPT-2 small's f32 forward through B1, and whose second is a CPU actor
    taking the argmax: 8 executions through execute_many, each held to
    this process's forward on the same card and weights, exactly."""
    from ray_tpu_torch.dag import InputNode, MultiOutputNode

    seed = 0
    batches = [np.random.default_rng(100 + i).integers(0, PROMPT_VOCAB, size=(DAG_B, DAG_T))
               for i in range(DAG_EXECUTIONS)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2.GPT2Config.small(dtype=torch.float32, remat=False)
    model = gpt2.init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
    model = model.to("cuda").eval()
    fa.flash_attention_fwd.launches = 0
    with torch.inference_mode():
        want = [model(torch.from_numpy(b).to("cuda"))[:, -1].cpu() for b in batches]
    driver_launches = fa.flash_attention_fwd.launches
    del model
    torch.cuda.empty_cache()

    # max_concurrency 2: the resident op loop holds one thread, the
    # launch-count and CUDA-state calls run beside it
    prefill_node = ray_tpu_torch.remote(num_gpus=1, max_concurrency=2)(Prefill).bind(seed)
    argmax_node = ray_tpu_torch.remote(num_cpus=1, max_concurrency=2)(Argmax).bind()
    with InputNode() as inp:
        logits = prefill_node.forward.bind(inp)
        ids = argmax_node.pick.bind(logits)
        dag = MultiOutputNode([logits, ids])
    t0 = time.perf_counter()
    # a batched frame carries 8 executions' logits ([4, 50304] f32 each)
    compiled = dag.experimental_compile(buffer_size_bytes=64 * 1024 * 1024,
                                        max_inflight=DAG_EXECUTIONS)
    res = {}
    try:
        if not compiled._channels_on:
            raise AssertionError("the compiled DAG is not on its channels")
        prefill = compiled._ctx["actors"][prefill_node._stable_uuid]
        argmax = compiled._ctx["actors"][argmax_node._stable_uuid]
        # set-up: one execution warms the card's libraries in Prefill and
        # imports torch in Argmax (to unpickle the tensor)
        ray_tpu_torch.get(compiled.execute(batches[0]), timeout=600)
        ray_tpu_torch.get(prefill.reset_launches.remote(), timeout=300)
        t_run = time.perf_counter()
        refs = compiled.execute_many(batches)
        outs = [ray_tpu_torch.get(r, timeout=600) for r in refs]
        res["run_s"] = time.perf_counter() - t_run
        res["launches"] = ray_tpu_torch.get(prefill.launches.remote(), timeout=60)
        res["argmax_cuda"] = ray_tpu_torch.get(argmax.cuda_state.remote(), timeout=60)
        res["kinds"] = sorted({d["kind"] for d in compiled._descs.values()})
        dtypes = sorted({f"{o[0].device.type}:{o[0].dtype}" for o in outs})
        bad = [i for i, (o, w) in enumerate(zip(outs, want))
               if not (isinstance(o[0], torch.Tensor) and o[0].device.type == "cpu"
                       and o[0].dtype == torch.float32 and torch.equal(o[0], w)
                       and o[1] == w.argmax(-1).tolist())]
        err = max((o[0].double() - w.double()).abs().max().item() for o, w in zip(outs, want))
    finally:
        compiled.teardown()
    res.update({"executions": DAG_EXECUTIONS, "bad": bad, "max_abs_diff": err,
                "logits": dtypes, "driver_launches": driver_launches,
                "seconds": time.perf_counter() - t0})
    deadline = time.monotonic() + 20
    rings = [n for n in _ring_dirs() if n.startswith("ray_tpu_torch_dag_")]
    while rings and time.monotonic() < deadline:
        time.sleep(0.2)
        rings = [n for n in _ring_dirs() if n.startswith("ray_tpu_torch_dag_")]
    res["dag_ring_dirs_left"] = rings
    want_launches = cfg.n_layer * DAG_EXECUTIONS
    print(f"[dataplane] compiled DAG, Prefill (num_gpus=1, GPT-2 small f32 on the card) -> "
          f"Argmax (CPU), MultiOutputNode([logits, ids]) over {res['kinds']} channels: "
          f"{DAG_EXECUTIONS} executions of [{DAG_B}, {DAG_T}] through execute_many in "
          f"{res['run_s']:.2f} s after one warm-up execution; logits reached the driver as {dtypes}, executions "
          f"differing from this process's forward {bad} (max |diff| {err:.3e}, want 0); "
          f"B1 launches in Prefill {res['launches']} (want {want_launches}); Argmax "
          f"{json.dumps(res['argmax_cuda'])}; dag ring dirs after teardown() {rings} — {card}",
          flush=True)
    if bad or err != 0.0 or dtypes != ["cpu:torch.float32"]:
        raise AssertionError(f"DAG logits differ from the driver's forward: {bad}, {err}")
    if res["launches"] != want_launches or driver_launches != want_launches:
        raise AssertionError(f"B1 launched {res['launches']} times in Prefill (driver "
                             f"{driver_launches}), want {want_launches}")
    if res["argmax_cuda"]["cuda_initialized"]:
        raise AssertionError(f"the CPU stage made a CUDA context: {res['argmax_cuda']}")
    if rings:
        raise AssertionError(f"ring directories left after teardown(): {rings}")
    return res


REPLICA_PROFILE_S = 1.5  # inside the bf16 mix's wall over the dataplane
# the step loop of the engine: the coroutine and the steps it hands its
# executor
ENGINE_LOOP_FRAMES = ("engine.py:_run", "engine.py:_decode_step", "engine.py:_prefill_step")
TRACED_MAX_TOKENS = 32


def _profile_replica() -> dict:
    """util.state.profile of the bf16 replica, on a thread beside the mix."""
    from ray_tpu_torch.util import state

    t0 = time.perf_counter()
    replica = _alive_actor(lambda a: (a.get("name") or "").startswith("SERVE_REPLICA::llm_bf16#"),
                           deadline_s=30)
    result = state.profile(replica["actor_id"], duration_s=REPLICA_PROFILE_S, mode="cpu")
    return {"replica_capture": {"replica": replica, "result": result,
                                "capture_s": time.perf_counter() - t0}}


def _hold_replica_profile(card: str, cap: dict) -> dict:
    result, replica = cap["result"], cap["replica"]
    merged = result.merged_samples()
    total = sum(merged.values())
    loop = sum(c for k, c in merged.items() if any(f in k for f in ENGINE_LOOP_FRAMES))
    share = loop / total if total else 0.0
    top = result.top_frames(10)
    out = {"replica": replica["actor_id"], "pid": replica["pid"], "complete": result.complete,
           "errors": result.errors, "total_samples": result.total_samples,
           "engine_loop_share": share,
           "engine_frame_shares": {f: result.attribution(f) for f in ENGINE_LOOP_FRAMES},
           "top_frames": [[f, c, round(fr, 4)] for f, c, fr in top],
           "capture_s": cap["capture_s"]}
    print(f"[dataplane] util.state.profile(replica {replica['name']}, pid {replica['pid']}, "
          f"duration_s={REPLICA_PROFILE_S}, mode='cpu') beside the bf16 mix: complete "
          f"{result.complete}, "
          f"{result.total_samples} samples, share in the engine's step loop "
          f"{ENGINE_LOOP_FRAMES} {share:.4f} ({json.dumps(out['engine_frame_shares'])}) — "
          f"{card}", flush=True)
    for f, c, fr in top:
        print(f"[dataplane]   top frame {f}: {c} samples ({fr:.4f})", flush=True)
    if not (result.complete and result.total_samples > 0 and share > 0):
        raise AssertionError(f"the replica's capture failed its holds: {out}")
    return out


async def _proxy_traced_request(proxy, traceparent: str, name: str, payload: dict):
    """Runs in the HTTP proxy's process (``__ray_call__``): one streamed
    request to deployment ``name`` through the proxy's own handle and
    router, under the context of ``traceparent``.  The proxy's HTTP handler
    (as the reference's) reads no traceparent header, so the header's
    context is installed here, as a proxy that honoured it would."""
    import asyncio
    import contextvars

    from ray_tpu_torch.util import tracing

    tracing.install_context(traceparent)
    with tracing.start_span("serve.proxy.request", {"deployment": name}):
        handle = proxy._handles[name]  # the one the HTTP route uses
        ctx = contextvars.copy_context()  # the executor's thread gets the trace
        loop = asyncio.get_running_loop()
        events = await loop.run_in_executor(
            proxy._route_pool, ctx.run,
            lambda: list(handle.options(stream=True).generate.remote(payload)))
    return {"tokens": [e["token"] for e in events if "token" in e],
            "done": events[-1].get("done"), "pid": os.getpid()}


def _traced_request(card: str, refs: dict) -> dict:
    """One bf16 request with a traceparent through the proxy: state.traces()
    gives one connected trace over the driver, the proxy and the replica;
    its critical path and state.dataplane()'s per-hop queue waits are
    printed."""
    from ray_tpu_torch.util import state, tracing

    proxy = ray_tpu_torch.get_actor("SERVE_PROXY", namespace="serve")
    pids = _serve_actor_pids()
    replica_pid = next(pid for name, pid in pids.items()
                       if name.startswith("SERVE_REPLICA::llm_bf16#"))
    payload = {"prompt": refs["mix"][3]["prompt"], "max_tokens": TRACED_MAX_TOKENS}
    t0 = time.perf_counter()
    with tracing.start_span("client.request") as root:
        out = ray_tpu_torch.get(proxy.__ray_call__.remote(
            _proxy_traced_request, tracing.current_traceparent(), "llm_bf16", payload),
            timeout=180)
    wall = time.perf_counter() - t0
    want = {"client.request", "serve.proxy.request", "serve.router", "channel.write",
            "channel.read", "serve.replica.stream", "serve.request", "serve.prefill",
            "serve.decode"}
    deadline, trace = time.monotonic() + 30, None
    while True:
        trace = next((t for t in state.traces() if t["trace_id"] == root.trace_id), None)
        if trace is not None:
            ids = {s["span_id"] for s in trace["spans"]}
            orphans = [s["name"] for s in trace["spans"]
                       if s.get("parent_span_id") and s["parent_span_id"] not in ids]
            names = {s["name"] for s in trace["spans"]}
            if (not orphans and want <= names
                    and {out["pid"], replica_pid} <= set(trace["pids"])):
                break
        if time.monotonic() > deadline:
            raise AssertionError(f"no connected trace over the proxy and the replica: "
                                 f"{trace and sorted({s['name'] for s in trace['spans']})}, "
                                 f"pids {trace and trace['pids']} (proxy {out['pid']}, replica "
                                 f"{replica_pid})")
        time.sleep(0.2)
    segments = [(e["name"], e["duration_s"] * 1e3) for e in trace["critical_path"]
                if e["segment"]]
    dp = state.dataplane()
    hops = [{"path": e["path"], "kind": e["kind"], "writes": e["writes"], "reads": e["reads"],
             "reattaches": e["reattaches"], "reattach_failures": e["reattach_failures"],
             "pids": e["pids"], "queue_wait_p50_ms": e["queue_wait"]["p50_s"] * 1e3,
             "queue_wait_p95_ms": e["queue_wait"]["p95_s"] * 1e3,
             "queue_wait_max_ms": e["queue_wait"]["max_s"] * 1e3,
             "reads_timed": e["queue_wait"]["count"]} for e in dp["edges"]]
    res = {"trace_id": root.trace_id, "span_count": trace["span_count"], "pids": trace["pids"],
           "proxy_pid": out["pid"], "replica_pid": replica_pid, "tokens": len(out["tokens"]),
           "wall_s": wall, "duration_s": trace["duration_s"],
           "critical_path_s": trace["critical_path_s"],
           "critical_path_ms": [[n, ms] for n, ms in segments], "hops": hops,
           "channel_counters": dp["counters"]}
    print(f"[dataplane] one traced bf16 request ({len(out['tokens'])} tokens) with a "
          f"traceparent through the proxy's handle: one connected trace of "
          f"{trace['span_count']} spans over pids {trace['pids']} (driver {os.getpid()}, proxy "
          f"{out['pid']}, replica {replica_pid}), {trace['duration_s'] * 1e3:.2f} ms end to end, "
          f"critical path {trace['critical_path_s'] * 1e3:.2f} ms — {card}", flush=True)
    print("[dataplane]   critical path segments (ms): "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in segments), flush=True)
    for h in hops:
        print(f"[dataplane]   hop {h['path']} ({h['kind']}, pids {h['pids']}): {h['writes']} "
              f"writes, {h['reads']} reads, {h['reattaches']} reattaches "
              f"({h['reattach_failures']} failed); queue wait p50 {h['queue_wait_p50_ms']:.3f} ms, "
              f"p95 {h['queue_wait_p95_ms']:.3f} ms, max {h['queue_wait_max_ms']:.3f} ms over "
              f"{h['reads_timed']} reads", flush=True)
    if len(out["tokens"]) != TRACED_MAX_TOKENS or not out["done"] or not hops:
        raise AssertionError(f"the traced request: {len(out['tokens'])} tokens, hops {hops}")
    return res


GRPC_MIX = (0, 5, 10, 15)  # which of the mix's requests go over gRPC


def _grpc_requests(card: str, refs: dict, grpc_port: int) -> dict:
    """(d) Four of the mix's f32 requests through the gRPC proxy's generic
    route to the f32 deployment, each equal to this process's engine."""
    import grpc

    channel = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
    call = channel.unary_unary("/ray_tpu.serve.UserDefinedService/llm_f32")
    try:
        futures = [call.future(json.dumps({"args": [refs["mix"][i]]}).encode(), timeout=300)
                   for i in GRPC_MIX]
        outs = [json.loads(f.result()) for f in futures]
    finally:
        channel.close()
    bad = [i for i, o in zip(GRPC_MIX, outs) if o["tokens"] != refs["want_f32"][i]]
    print(f"[dataplane] gRPC ingress (serve.start(grpc_port=...)): requests {list(GRPC_MIX)} "
          f"of the f32 mix, {sum(len(o['tokens']) for o in outs)} greedy tokens, differing "
          f"from this process's engine: {bad} — {card}", flush=True)
    if bad:
        raise AssertionError(f"f32 tokens over gRPC differ from the engine at {bad}")
    return {"grpc_requests": len(outs)}


def phase_dataplane(card: str, engine_serve: dict, plane: dict) -> dict:
    """Phase 16's traffic again, now over the replicas' channel dataplane
    (the default configuration), then a compiled DAG with a GPU stage and
    the gRPC ingress, under a cluster of its own.  ``plane`` is phase
    16's result: its references and its RPC-path numbers."""
    t0 = time.perf_counter()
    refs = plane["refs"]
    port, grpc_port = _free_port(), _free_port()
    ctx = ray_tpu_torch.init(num_cpus=4)
    res = {"session_dir": ctx["session_dir"], "card": card, "http_port": port,
           "grpc_port": grpc_port}
    try:
        rt_serve.start(http_port=port, grpc_port=grpc_port)
        res.update(_serve_http(
            "dataplane", card, engine_serve, refs, port,
            while_f32=lambda: _grpc_requests(card, refs, grpc_port),
            control=("SERVE_CONTROLLER", "SERVE_PROXY", "SERVE_GRPC_PROXY"),
            while_bf16=_profile_replica))
        dp, n = res["served"]["dataplane"], res["requests"]
        want_items = res["tokens"] + 2 * n  # a stream's meta event and summary
        print(f"[dataplane] the channel carried it all: the replica answered "
              f"{res['served']['streams_answered']} streams, its dataplane served "
              f"{dp['stream']} streams (want {n}) and {dp['stream_items']} stream items "
              f"(want {res['tokens']} tokens + {2 * n} meta and summary events); over RPC "
              f"(phase 16) decode {plane['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{plane['ttft_p50_s'] * 1e3:.1f} ms p95 {plane['ttft_p95_s'] * 1e3:.1f} ms, "
              f"wall {plane['wall_s']:.2f} s — {card}", flush=True)
        if dp["stream"] != n or dp["stream_items"] != want_items:
            raise AssertionError(f"not every stream rode the dataplane: {dp}, want {n} "
                                 f"streams and {want_items} items")
        res["rpc_decode_tok_per_s"] = plane["decode_tok_per_s"]
        res["rpc_ttft_p50_s"], res["rpc_ttft_p95_s"] = plane["ttft_p50_s"], plane["ttft_p95_s"]
        res["rpc_wall_s"] = plane["wall_s"]
        t_obs = time.perf_counter()
        res["replica_profile"] = _hold_replica_profile(card, res.pop("replica_capture"))
        res["traced_request"] = _traced_request(card, refs)
        print(f"[timing] dataplane profile and traced request: "
              f"{time.perf_counter() - t_obs + res['replica_profile']['capture_s']:.1f} s "
              f"(the capture's {res['replica_profile']['capture_s']:.1f} s ran beside the mix)",
              flush=True)
        rt_serve.delete("llm_bf16")
        res["dag"] = _dag_gpu_stage(card)
    finally:
        try:
            rt_serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    _shut_down("dataplane", res, t0)
    print("[dataplane] " + json.dumps(res), flush=True)
    return res


def phase_static_kernel(card: str, launches: int) -> dict:
    """B1 at the static batch's prefill, [4, T_max, 12, 64] float32 with
    q/k/v as views of the fused projection: held against its plain
    version, then timed beside it, its bound and one library call."""
    B, T, H, D = len(STATIC_LENS), max(STATIC_LENS), 12, 64
    q, k, v = _qkv(T, H, D, torch.float32, True, seed=123, B=B)
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v)
    e_o = (out - ref_out).abs().max().item()
    e_l = (lse - ref_lse).abs().max().item()
    # f32: both sides compute in f32 and differ only in summation order
    print(f"[static kernel] flash_fwd [{B}, {T}, {H}, {D}] float32 fused: max|dO|={e_o:.3e} "
          f"max|dLSE|={e_l:.3e} (tol 1e-4)", flush=True)
    if not (e_o <= 1e-4 and e_l <= 1e-4):
        raise AssertionError(f"flash_fwd disagrees with its plain version at [{B}, {T}] f32")
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    plain_ms = _time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v), reps=5, rounds=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    rec = _record("flash_attention_fwd", "serve plane static batch", (B, T, H, D), ms,
                  plain_ms, library_ms, *_fwd_work(B, T, H, D, elt=4), e_o,
                  dtype="float32", max_abs_err_lse=e_l)
    rec["launches"] = launches
    _print_record("static kernel", rec, card)
    return rec


# ----------------------------------------------------------------------
# Ray Data and the device collective group: GPT-2 medium trains inside
# TorchTrainer.fit() from token shards streamed through read_numpy and
# streaming_split, and a world-size-1 NCCL group in a GPU actor
# ----------------------------------------------------------------------
DATA_SHARDS, DATA_SHARD_ROWS, DATA_B = 8, 64, 16  # 8 .npy files of [64, 1025] int32


def _fingerprints(rows: np.ndarray) -> list:
    """Per row, the int64 sum of the token ids weighted by position
    (1, 2, ...): gpt2_loop's fingerprint of a batch."""
    w = np.arange(1, rows.shape[1] + 1, dtype=np.int64)
    return (rows.astype(np.int64) * w).sum(axis=1).tolist()


def _write_token_shards(root: str, seed: int) -> list:
    """Pre-tokenised shards as pretraining reads them: DATA_SHARDS .npy
    files of [DATA_SHARD_ROWS, TRAIN_T + 1] int32 ids below the tokenizer's
    50,257; returns the shards."""
    rng = np.random.default_rng(seed)
    shards = [rng.integers(0, PROMPT_VOCAB, size=(DATA_SHARD_ROWS, TRAIN_T + 1), dtype=np.int32)
              for _ in range(DATA_SHARDS)]
    for i, shard in enumerate(shards):
        np.save(os.path.join(root, f"tokens_{i:02d}.npy"), shard)
    return shards


def _rows_delivered(shards: list, rows: np.ndarray) -> list:
    """(file, row) of each delivered row; raises unless every one is a row
    of the shards and none comes twice."""
    where = {r.tobytes(): (f, i) for f, shard in enumerate(shards) for i, r in enumerate(shard)}
    got = [where.get(r.tobytes()) for r in rows]
    if None in got or len(set(got)) != len(got):
        raise AssertionError(f"delivered rows are not distinct rows of the shards: {got}")
    return got


def _data_raw_run(cfg, rows: np.ndarray) -> dict:
    """The driver's raw run: the same seed-0 weights and the same 16-row
    batches in file order, through make_train_step with no runtime."""
    n = TRAIN_WARMUP + TRAIN_STEPS
    batches = torch.from_numpy(rows[:n * DATA_B].astype(np.int64)).to("cuda")
    batches = batches.view(n, DATA_B, TRAIN_T + 1)
    model = gpt2.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    step = gpt2.make_train_step(cfg, gpt2.make_adamw(model.parameters(), lr=TRAIN_LR))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses = [step(model, b[:, :-1], b[:, 1:]) for b in batches[:TRAIN_WARMUP]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(model, b[:, :-1], b[:, 1:]) for b in batches[TRAIN_WARMUP:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"losses": [x.item() for x in losses], "step_ms": wall / TRAIN_STEPS * 1e3,
           "launches": list(_launch_counts()),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    # where the time goes: two more steps under torch.profiler
    out["profile"] = _profile_step(lambda: step(model, batches[0, :, :-1], batches[0, :, 1:]),
                                   steps=2)
    del model, step, batches, losses
    torch.cuda.empty_cache()  # the card's memory goes to the trainer's worker
    return out


@ray_tpu_torch.remote(num_gpus=1)
class NCCLMember:
    """A GPU actor that forms a world-size-1 "nccl" collective group and
    runs the device path, the host path and a generation bump."""

    def run(self, name: str) -> dict:
        import numpy as np
        import torch

        from ray_tpu_torch.util import collective
        from ray_tpu_torch.util.collective import collective as impl

        collective.init_collective_group(1, 0, backend="nccl", group_name=name)
        g0 = impl._manager.get(name)
        dev = torch.device("cuda", torch.cuda.current_device())
        gen = torch.Generator(device=dev).manual_seed(0)
        out = {"backend": g0.device_backend(), "pg_class": type(g0._pg).__name__,
               "default_group_initialized": torch.distributed.is_initialized(), "ops": {}}
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(1000, 37, generator=gen, device=dev).to(dt)
            got = {"allreduce": [collective.allreduce(x, group_name=name)],
                   "broadcast": [collective.broadcast(x, 0, group_name=name)],
                   "allgather": collective.allgather(x, group_name=name)}
            out["ops"][str(dt)] = {
                op: [(str(t.device), str(t.dtype), bool(torch.equal(t, x))) for t in ts]
                for op, ts in got.items()}
        arr = np.arange(12.0).reshape(3, 4)
        back = collective.allreduce(arr, group_name=name)
        out["numpy"] = [type(back).__name__, bool(np.array_equal(back, arr))]
        collective.init_collective_group(1, 0, backend="nccl", group_name=name, generation=1)
        g1 = impl._manager.get(name)
        y = torch.ones(8, device=dev)
        out["regen"] = {"generation": g1.generation, "backend": g1.device_backend(),
                        "equal": bool(torch.equal(collective.allreduce(y, group_name=name), y))}
        try:
            g0.allreduce(y)
            out["old_generation"] = "completed"
        except collective.GroupInvalidatedError:
            out["old_generation"] = "GroupInvalidatedError"
        collective.destroy_collective_group(name)
        out["default_group_initialized_after"] = torch.distributed.is_initialized()
        return out


def _check_nccl(out: dict, card: str) -> None:
    print(f"[data] nccl group (world size 1, num_gpus=1 actor): process group {out['pg_class']} "
          f"backend {out['backend']!r}, default torch.distributed group initialised "
          f"{out['default_group_initialized']} / {out['default_group_initialized_after']}; "
          f"(device, dtype, equal) per op {out['ops']}; numpy through the host ring "
          f"{out['numpy']}; generation 1 {out['regen']}; a call on generation 0 -> "
          f"{out['old_generation']} — {card}", flush=True)
    for dt, ops in out["ops"].items():
        for op, results in ops.items():
            if len(results) != 1 or not all(  # world size 1: one tensor each
                    d.startswith("cuda") and t == dt and eq for d, t, eq in results):
                raise AssertionError(f"nccl {op} of a {dt} CUDA tensor: {results}")
    if out["backend"] != "nccl" or out["pg_class"] != "ProcessGroupNCCL":
        raise AssertionError(f"the device group did not form NCCL: {out}")
    if out["default_group_initialized"] or out["default_group_initialized_after"]:
        raise AssertionError("the device group touched the default torch.distributed group")
    if out["numpy"] != ["ndarray", True]:
        raise AssertionError(f"numpy through the host ring: {out['numpy']}")
    if out["regen"] != {"generation": 1, "backend": "nccl", "equal": True}:
        raise AssertionError(f"the generation bump did not re-form the group: {out['regen']}")
    if out["old_generation"] != "GroupInvalidatedError":
        raise AssertionError(f"a call on the old generation: {out['old_generation']}")


def phase_data(card: str) -> dict:
    """GPT-2 medium at the reference's defaults (f32 params, bf16 compute,
    remat) trains for 13 steps inside TorchTrainer.fit() from token shards
    read by read_numpy and dealt by streaming_split, each batch copied to
    the card one step ahead by iter_device_batches; held to Data's own
    order and to the driver's raw run on the same rows.  Then the device
    collective group, and B1, B2, B3 at GPT-2 medium's attention shape."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch._private.worker import global_worker_maybe

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = gpt2.GPT2Config.medium(param_dtype=torch.float32)
    n = TRAIN_WARMUP + TRAIN_STEPS
    want = [2 * cfg.n_layer * n, cfg.n_layer * n, cfg.n_layer * n]  # B1 twice under remat
    res = {"card": card, "config": f"GPT-2 medium, f32 params, bf16 compute, remat, "
                                   f"B={DATA_B}, T={TRAIN_T}, AdamW lr {TRAIN_LR}"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as root:
        shards = _write_token_shards(root, seed=9)
        ctx = ray_tpu_torch.init(num_cpus=4)
        res["session_dir"] = ctx["session_dir"]
        try:
            # Data's own order: the reference deals files round-robin to its
            # read tasks (ray_tpu/data/datasource.py:179-183) and keeps task
            # order, not file order; the trainer's path must deliver this
            ordered = [b["data"] for b in rd.read_numpy(root).iter_batches(
                batch_size=DATA_B, drop_last=True, prefetch_batches=0)][:n]
            rows = np.concatenate(ordered)
            where = _rows_delivered(shards, rows)
            _reset_counts()
            with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as storage:
                result = TorchTrainer(
                    train_loop_per_worker,
                    train_loop_config={"cfg": cfg, "seed": 0, "lr": TRAIN_LR,
                                       "warmup": TRAIN_WARMUP, "steps": TRAIN_STEPS,
                                       "batch_size": DATA_B, "device": "cuda",
                                       "peak_flops": PEAK_BF16_FLOPS},
                    datasets={"train": rd.read_numpy(root)},
                    scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                    run_config=RunConfig(name="gpt2_medium_data", storage_path=storage),
                ).fit()
            m = result.metrics
            res["driver_launches_during_fit"] = list(_launch_counts())
            # the data side: the pooled workers that ran the read and split
            # tasks (the split coordinator has gone with the trainer's
            # iterators); the training worker (m["pid"], when it has not
            # exited) is the positive control
            actors = global_worker_maybe().gcs_client.call("list_actors", None)
            coordinators = [a["pid"] for a in actors
                            if a["class_name"] == "_SplitCoordinator" and a["state"] == "ALIVE"]
            procs = _port_processes()
            others = sorted(pid for pid in procs if pid != m["pid"])
            with_libs = {pid: [lib for lib in ("libtorch", "libcuda") if _maps_lib(pid, lib)]
                         for pid in others}
            with_libs = {pid: libs for pid, libs in with_libs.items() if libs}
            workers = [pid for pid in others if "default_worker" in procs[pid]]
            trainer_libs = ([lib for lib in ("libtorch", "libcuda") if _maps_lib(m["pid"], lib)]
                            if m["pid"] in procs else "exited")
            res["data_side"] = {"port_processes": others, "workers": workers,
                                "split_coordinators": coordinators,
                                "with_torch_or_cuda": with_libs,
                                "train_worker": m["pid"], "train_worker_libs": trainer_libs}
            res["nccl"] = ray_tpu_torch.get(NCCLMember.remote().run.remote("chip_smoke_nccl"),
                                            timeout=600)
        finally:
            ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 20
    left, rings = _port_processes(), _ring_dirs()
    while (left or rings) and time.monotonic() < deadline:
        time.sleep(0.5)
        left, rings = _port_processes(), _ring_dirs()
    res["processes_left"], res["ring_dirs_left"] = left, rings
    raw = _data_raw_run(cfg, rows)  # the card is free again: the worker has exited

    losses = m["losses"]
    fp_ok = m["fingerprints"] == [_fingerprints(b) for b in ordered]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, raw["losses"])]
    files = [f for f, _ in where[::DATA_B]]
    res["trainer"] = {k: v for k, v in m.items() if k != "fingerprints"}
    res["raw"] = raw
    res["fingerprints_equal"] = fp_ok
    res["files_by_step"] = files
    res["loss_rel_err_vs_raw"] = max(rels)
    print(f"[data] read_numpy of {DATA_SHARDS} shards [{DATA_SHARD_ROWS}, {TRAIN_T + 1}] int32 -> "
          f"streaming_split(1, equal=True) -> iter_device_batches(batch_size={DATA_B}, "
          f"prefetch_batches=2) -> GPT-2 medium in TorchTrainer.fit() on "
          f"{m.get('device_name')}: batches {m['batch_kinds']}; {n * DATA_B} distinct shard rows, "
          f"step by step from files {files}; every step's fingerprint equal to Data's own "
          f"order (iter_batches in the driver): {fp_ok} — {card}", flush=True)
    print(f"[data] in fit(): loss {losses[0]:.4f} -> {losses[-1]:.4f} over {n} steps; step "
          f"{m['step_ms']:.2f} ms, {m['tokens_per_s']:.0f} tok/s, MFU {m['mfu']:.4f} at "
          f"{gpt2.flops_per_token(cfg, TRAIN_T) / 1e9:.4f} GFLOP/token, peak memory "
          f"{m['peak_memory_gb']:.2f} GB; wait in next() per timed step mean "
          f"{m['data_wait_ms_mean']:.3f} ms max {m['data_wait_ms_max']:.3f} ms (all steps "
          f"{[round(w, 3) for w in m['data_wait_ms']]}) — {card}", flush=True)
    print(f"[data] raw run in the driver on the same rows and seed: step {raw['step_ms']:.2f} ms, "
          f"peak {raw['peak_memory_gb']:.2f} GB; losses max rel {max(rels):.2e} over "
          f"{len(rels)} steps (tol 1e-5); launches B1/B2/B3 in the worker {m['launches']} "
          f"(want {want}: B1 twice a layer under remat), raw {raw['launches']}, the driver's "
          f"during fit() {res['driver_launches_during_fit']} — {card}", flush=True)
    prof = raw["profile"]
    print(f"[data] raw step profiled: {prof['profiled_step_ms']:.2f} ms, device busy "
          f"{prof['device_busy_ms_per_step']:.2f} ms, idle share "
          f"{prof['device_idle_share']:.4f}; by kind {_fmt_ms(prof['device_ms_by_kind'])}; "
          f"flash per step {_fmt_ms(prof['flash_ms_per_step'])} — {card}", flush=True)
    print(f"[data] data side after fit(): port processes {others} (workers {workers}, split "
          f"coordinator(s) {coordinators}) mapping libtorch or libcuda: {with_libs}; the "
          f"training worker {m['pid']}: {trainer_libs}; after shutdown(): processes left "
          f"{sorted(left)}, ring directories left {rings}", flush=True)
    if not fp_ok:
        raise AssertionError("the trainer's batches differ from Data's own order")
    if m["batch_kinds"] != [(f"cuda:{torch.cuda.current_device()}", "torch.int64")]:
        raise AssertionError(f"batches reached the step as {m['batch_kinds']}")
    if len(losses) != n or max(rels) > 1e-5:
        raise AssertionError(f"in-framework losses {losses} != raw {raw['losses']}")
    if m["launches"] != want or raw["launches"] != want:
        raise AssertionError(f"launched {m['launches']} in the worker, {raw['launches']} raw; "
                             f"want {want}")
    if res["driver_launches_during_fit"] != [0, 0, 0]:
        raise AssertionError("the driver's counts moved during fit(): the step ran here")
    if not (m["finite"] and losses[-1] < losses[0]):
        raise AssertionError(f"in-framework loss not finite and falling: {losses}")
    if with_libs or not workers:
        raise AssertionError(f"the data side maps torch or CUDA, or ran nowhere: "
                             f"{res['data_side']}")
    if left or rings:
        raise AssertionError(f"left after shutdown(): processes {left}, ring dirs {rings}")
    _check_nccl(res["nccl"], card)

    # B1, B2, B3 at GPT-2 medium's attention: q/k/v views of the fused qkv
    B, T, H, D = DATA_B, TRAIN_T, cfg.n_head, cfg.d_head
    g = torch.Generator(device="cuda").manual_seed(400)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
    errs = _hold_bf16_kernels("data kernels", "GPT-2 medium shape", "fused", q, k, v, do)
    recs = _time_bf16_kernels("data kernels", "data", q, k, v, do, errs, card)
    for rec, launches in zip(recs, m["launches"]):
        rec["launches"] = launches
    res["kernels"] = recs
    res["seconds"] = time.perf_counter() - t0
    print(f"[data] phase took {res['seconds']:.1f} s", flush=True)
    print("[data] " + json.dumps(res), flush=True)
    res["rows"] = rows  # phase 19 trains on the same rows; not printed
    return res


# ----------------------------------------------------------------------
# The sharded planes: GPT-2 medium under a ShardingConfig inside
# TorchTrainer.fit() on a one-card mesh, a sharded checkpoint and its
# resume, and ring attention's per-block path for emulated ranks
# ----------------------------------------------------------------------
RING_N = 4  # emulated ranks of the ring: [16, 1024] splits into blocks of 256
# the checkpoint drill's model: GPT-2 medium's widths at 2 of its 24 layers
# (a 1.5 GB checkpoint where the whole model's is 4.9 GB)
RESUME_AT, RESUME_LAYERS = 6, 2


def _ring_hold(q, k, v, do) -> dict:
    """The ring's per-block steps for RING_N ranks emulated on the card
    (``ring_attention.emulate_ring``), with the launch counts set to 0
    just before and read just after; each non-causal launch held against
    its plain version on the same block (B1's O by row at O_ROW_TOL, the
    LSE at 1e-3, B2/B3 at 1e-2 of max |ref|), a planted fault (one 64-key
    V tile of a block zeroed in the plain version) read by the same row
    check; then the merged O, dq, dk and dv against B1, B2 and B3 causal
    over the whole T."""
    from ray_tpu_torch.ops import ring_attention as ra

    errs = {"fwd": [], "fwd_row": [], "lse": [], "dq": [], "dk": [], "dv": []}

    def fwd(qb, kb, vb, causal):
        o, lse = ra.block_forward(qb, kb, vb, causal)
        if not causal:
            torch.cuda.synchronize()
            ro, rlse = fa.flash_attention_fwd_reference(qb, kb, vb, causal=False)
            errs["fwd"].append((o.float() - ro.float()).abs().max().item())
            errs["fwd_row"].append(_row_rel(o, ro))
            errs["lse"].append((lse - rlse).abs().max().item())
            if "fault" not in errs:
                v_fault = vb.clone()
                v_fault[:, 64:128] = 0
                errs["fault"] = _row_rel(
                    fa.flash_attention_fwd_reference(qb, kb, v_fault, causal=False)[0], ro)
        return o, lse

    def bwd(qb, kb, vb, dob, lse, delta, causal):
        got = ra.block_backward(qb, kb, vb, dob, lse, delta, causal)
        if not causal:
            torch.cuda.synchronize()
            ref = (fa.flash_attention_dq_reference(qb, kb, vb, dob, lse, delta, False),
                   *fa.flash_attention_dkv_reference(qb, kb, vb, dob, lse, delta, False))
            for key, a, b in zip(("dq", "dk", "dv"), got, ref):
                errs[key].append(_rel(a, b))
        return got

    _reset_counts()
    out, dq, dk, dv = ra.emulate_ring(q, k, v, do, RING_N, fwd=fwd, bwd=bwd)
    torch.cuda.synchronize()
    launches = list(_launch_counts())
    o, lse = fa.flash_attention_fwd(q, k, v)
    whole = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    _reset_counts()  # the whole-T references are not the ring's launches
    return {
        "launches": launches,
        "noncausal_blocks": len(errs["fwd"]),
        "block_fwd": max(errs["fwd"]), "block_fwd_row": max(errs["fwd_row"]),
        "block_lse": max(errs["lse"]), "block_fault_row": errs["fault"],
        **{f"block_{key}": max(errs[key], key=lambda e: e[1]) for key in ("dq", "dk", "dv")},
        "o_vs_whole": (out.float() - o.float()).abs().max().item(),
        "o_vs_whole_row": _row_rel(out, o),
        **{f"{name}_vs_whole": _rel(a, b)
           for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), whole)},
    }


def phase_sharded(card: str, data: dict) -> dict:
    """GPT-2 medium as phase 18 (the same eight token shards, read_numpy
    and streaming_split to one GPU worker, f32 params, bf16 compute, remat,
    B=16, T=1024, AdamW lr 3e-4, 13 steps) under
    TorchTrainer(sharding_config=ShardingConfig(mesh_shape={"batch": -1,
    "model": 1})): gpt2_loop calls plan_from_context(), shard_init and
    jit_train_step, and takes each batch from iter_device_batches(sharding=
    plan.data_sharding()).  Held to phase 18's raw run (the same weights
    and rows) and to its own resume from a sharded checkpoint; then the
    ring attention block path for emulated ranks on the card, and B1, B2,
    B3 non-causal at the ring block [16, 256, 16, 64]."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train.sharding import ShardingConfig

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = gpt2.GPT2Config.medium(param_dtype=torch.float32)
    n, resume_at = TRAIN_WARMUP + TRAIN_STEPS, RESUME_AT
    want = [2 * cfg.n_layer * n, cfg.n_layer * n, cfg.n_layer * n]
    raw = data["raw"]
    res = {"card": card, "config": f"GPT-2 medium, f32 params, bf16 compute, remat, "
                                   f"B={DATA_B}, T={TRAIN_T}, AdamW lr {TRAIN_LR}, "
                                   f"ShardingConfig(mesh_shape={{'batch': -1, 'model': 1}})"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as root:
        shards = _write_token_shards(root, seed=9)  # phase 18's shards
        ray_tpu_torch.init(num_cpus=4)
        try:
            ordered = [b["data"] for b in rd.read_numpy(root).iter_batches(
                batch_size=DATA_B, drop_last=True, prefetch_batches=0)][:n]
            rows = np.concatenate(ordered)
            _rows_delivered(shards, rows)
            _reset_counts()
            with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_train_") as storage:
                result = TorchTrainer(
                    train_loop_per_worker,
                    train_loop_config={"cfg": cfg, "seed": 0, "lr": TRAIN_LR,
                                       "warmup": TRAIN_WARMUP, "steps": TRAIN_STEPS,
                                       "batch_size": DATA_B, "device": "cuda",
                                       "peak_flops": PEAK_BF16_FLOPS, "resume_at": resume_at,
                                       "resume_layers": RESUME_LAYERS},
                    datasets={"train": rd.read_numpy(root)},
                    scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                    run_config=RunConfig(name="gpt2_medium_sharded", storage_path=storage),
                    sharding_config=ShardingConfig(mesh_shape={"batch": -1, "model": 1}),
                ).fit()
            m = result.metrics
            res["driver_launches_during_fit"] = list(_launch_counts())
        finally:
            ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 20
    left = _port_processes()
    while left and time.monotonic() < deadline:
        time.sleep(0.5)
        left = _port_processes()
    res["processes_left"] = left
    res["fit_seconds"] = time.perf_counter() - t0

    losses = m["losses"]
    same_rows = bool(np.array_equal(rows, data["rows"][:len(rows)]))
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, raw["losses"])]
    unbroken = m["unbroken_losses"]  # the drill's model, every batch from the seed
    replay = [abs(a - b) / abs(b) for a, b in zip(m["replay_losses"], unbroken[:resume_at])]
    resumed = [abs(a - b) / abs(b) for a, b in zip(m["resumed_losses"], unbroken[resume_at:])]
    fp_ok = m["fingerprints"] == [_fingerprints(b) for b in ordered]
    res["trainer"] = {k: v for k, v in m.items() if k != "fingerprints"}
    res.update(loss_rel_err_vs_raw=max(rels), replay_rel_err=max(replay),
               resume_rel_err=max(resumed), fingerprints_equal=fp_ok,
               rows_equal_to_phase18=same_rows)
    print(f"[sharded] {m['device_name']}: mesh {m['mesh']} ({m['mesh_device_type']}); every "
          f"parameter a DTensor with the rule table's placements {m['params_on_rule_placements']}, "
          f"AdamW moments on the parameters' placements {m['moments_follow_params']}; qkv "
          f"{m['qkv_placements']} local {m['qkv_local_shape']}; batches "
          f"{m['batch_placements']} {m['batch_kinds']}, fingerprints equal to Data's own order "
          f"{fp_ok} (rows equal to phase 18's {same_rows}) — {card}", flush=True)
    print(f"[sharded] in fit(): loss {losses[0]:.4f} -> {losses[-1]:.4f} over {n} steps; step "
          f"{m['step_ms']:.2f} ms against the raw step's {raw['step_ms']:.2f} ms (phase 18, this "
          f"run), {m['tokens_per_s']:.0f} tok/s, MFU {m['mfu']:.4f}, peak memory "
          f"{m['peak_memory_gb']:.2f} GB; losses vs the raw run's max rel {max(rels):.2e} (tol "
          f"1e-5); launches B1/B2/B3 in the worker {m['launches']} (want {want}), the driver's "
          f"during fit() {res['driver_launches_during_fit']} — {card}", flush=True)
    print(f"[sharded] checkpoint drill on GPT-2 medium's widths at {m['resume_layers']} layers "
          f"(the same rows and seed, without the data iterator): an unbroken run of {n} steps "
          f"at {m['unbroken_step_ms']:.2f} ms a step; checkpoint at step {resume_at} "
          f"({m['checkpoint_files']}, {m['checkpoint_bytes'] / 1e9:.3f} GB; save "
          f"{m['checkpoint_save_s']:.1f} s, load {m['checkpoint_load_s']:.1f} s): replayed steps "
          f"1..{resume_at} max rel {max(replay):.2e} at {m['replay_step_ms']:.2f} ms a step, steps "
          f"{resume_at + 1}..{n} after loading into a fresh plan max rel {max(resumed):.2e} (tol "
          f"1e-6) at {m['resumed_step_ms']:.2f} ms a step, both against the unbroken run; fit() "
          f"and the drill took {res['fit_seconds']:.1f} s; after shutdown() port processes left "
          f"{sorted(left)}", flush=True)
    if not (m["params_on_rule_placements"] and m["moments_follow_params"]
            and m["mesh"] == {"batch": 1, "model": 1} and m["mesh_device_type"] == "cuda"):
        raise AssertionError(f"the sharded state is not on the rule placements: {res['trainer']}")
    if m["launches"] != want or res["driver_launches_during_fit"] != [0, 0, 0]:
        raise AssertionError(f"launched {m['launches']} in the worker (want {want}), "
                             f"{res['driver_launches_during_fit']} in the driver")
    if len(losses) != n or max(rels) > 1e-5 or not same_rows:
        raise AssertionError(f"sharded losses {losses} != raw {raw['losses']}")
    if (max(replay) > 1e-6 or max(resumed) > 1e-6 or len(unbroken) != n
            or m["resume_layers"] != RESUME_LAYERS):
        raise AssertionError(f"resume: replay {m['replay_losses']}, resumed "
                             f"{m['resumed_losses']} vs unbroken {unbroken}")
    if not fp_ok or [(kind, pl) for kind, _, pl in m["batch_placements"]] != [
            ("DTensor", "(Replicate(), Replicate())")] or "'cuda'" not in m["batch_placements"][0][1]:
        raise AssertionError(f"batches: fingerprints equal {fp_ok}, {m['batch_placements']}")
    if m["batch_kinds"] != [(f"cuda:{torch.cuda.current_device()}", "torch.int64")]:
        raise AssertionError(f"batches reached the step as {m['batch_kinds']}")
    if left:
        raise AssertionError(f"left after shutdown(): processes {left}")

    # (c) the ring's per-block path: GPT-2 medium's attention, T split
    # into RING_N blocks of 256, every rank's blocks in the ring's order
    B, T, H, D = DATA_B, TRAIN_T, cfg.n_head, cfg.d_head
    g = torch.Generator(device="cuda").manual_seed(500)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    ring = _ring_hold(q, k, v, do)
    res["ring"] = ring
    nb = ring["noncausal_blocks"]
    print(f"[sharded] ring of {RING_N} emulated ranks at [{B}, {T}, {H}, {D}] bf16: launches "
          f"B1/B2/B3 {ring['launches']} ({nb} non-causal blocks each); each non-causal block "
          f"[{B}, {T // RING_N}, {H}, {D}] vs plain: B1 max|dO| {ring['block_fwd']:.3e} (tol "
          f"0.02), by row {ring['block_fwd_row']:.3e} (tol {O_ROW_TOL:g}; one V tile zeroed reads "
          f"{ring['block_fault_row']:.3e}), max|dLSE| {ring['block_lse']:.3e} (tol 0.001); "
          f"max|err|/max|ref| dq {ring['block_dq'][1]:.3e} dk {ring['block_dk'][1]:.3e} dv "
          f"{ring['block_dv'][1]:.3e} (tol 0.01) — {card}", flush=True)
    print(f"[sharded] merged ring vs B1/B2/B3 causal over the whole T: O max|d| "
          f"{ring['o_vs_whole']:.3e} (tol 0.02), by row {ring['o_vs_whole_row']:.3e} (tol "
          f"{O_ROW_TOL:g}); max|err|/max|ref| dq {ring['dq_vs_whole'][1]:.3e} dk "
          f"{ring['dk_vs_whole'][1]:.3e} dv {ring['dv_vs_whole'][1]:.3e} (tol 0.01)", flush=True)
    blocks_ok = (ring["block_fwd"] <= 2e-2 and ring["block_fwd_row"] <= O_ROW_TOL
                 and ring["block_lse"] <= 1e-3
                 and all(ring[f"block_{x}"][1] <= 1e-2 for x in ("dq", "dk", "dv")))
    whole_ok = (ring["o_vs_whole"] <= 2e-2 and ring["o_vs_whole_row"] <= O_ROW_TOL
                and all(ring[f"{x}_vs_whole"][1] <= 1e-2 for x in ("dq", "dk", "dv")))
    ring_launches = RING_N * (RING_N + 1) // 2
    if not (blocks_ok and whole_ok) or ring["launches"] != [ring_launches] * 3 or nb != (
            ring_launches - RING_N):
        raise AssertionError(f"the ring's block path disagrees: {ring}")
    if ring["block_fault_row"] <= O_ROW_TOL:
        raise AssertionError(f"the block row check cannot see a zeroed V tile "
                             f"({ring['block_fault_row']:.3e} <= {O_ROW_TOL:g})")

    # B1, B2, B3 non-causal at the ring block, timed
    qb, kb, vb, dob = (t[:, :T // RING_N].contiguous() for t in (q, k, v, do))
    errs = {"fwd": ring["block_fwd"], "fwd_row": ring["block_fwd_row"],
            "fwd_fault_row": ring["block_fault_row"], "lse": ring["block_lse"],
            **{x: ring[f"block_{x}"] for x in ("dq", "dk", "dv")}}
    recs = _time_bf16_kernels("sharded kernels", "ring block", qb, kb, vb, dob, errs, card,
                              causal=False, sleep_cycles=50_000_000, delta_in_dq=False)
    for rec in recs:
        rec["launches"] = nb  # the non-causal launches of the ring's run
        rec["causal_launches_in_ring"] = RING_N
    res["kernels"] = recs
    res["seconds"] = time.perf_counter() - t0
    print(f"[sharded] phase took {res['seconds']:.1f} s", flush=True)
    print("[sharded] " + json.dumps(res), flush=True)
    return res


# ----------------------------------------------------------------------
# The pipeline planes: GPT-2 medium over a two-stage MPMD pipeline of GPU
# stage actors sharing the card, the kernels at its microbatch, and the
# SPMD pipeline's schedule at GPT-2 medium's widths
# ----------------------------------------------------------------------
PP_STAGES, PP_M, PP_STEPS = 2, 4, 8  # the bf16 run: 2 stages, 4 microbatches, 8 steps
PP_WARMUP = 2  # the first steps hold the stages' warm-up (allocator, cuBLAS): not timed
PP_PARITY_LAYERS, PP_PARITY_STEPS, PP_DRILL_STEPS = 2, 3, 4
# one activation frame is [4, 1024, 1024] f32, 16 MiB; 1F1B keeps up to
# `stages` frames in flight on an edge
PP_RING = 80 << 20
# a step's result deadline: a plane's first step holds its stages' warm-up
# (up to 10 s in one H100 machine's run); a killed stage costs this wait
PP_STEP_TIMEOUT_S = 20.0
# The bf16 run's losses after step 1 against phase 18's raw run on the same
# weights and rows: the microbatches' matmuls round in bf16 at other shapes
# ([4, 1024] rows against [16, 1024]), so every gradient differs from the
# raw step's by bf16 rounding, and AdamW's normalised update moves each
# weight by about lr whatever its gradient's size; over 8 steps at lr 3e-4
# the loss drifts apart by far less than the 0.1 a step it falls, and 1e-2
# relative bounds that drift while a step that lost or doubled a
# microbatch's gradient departs by more
PP_LOSS_TOL = 1e-2


def _wait_no_port_processes(tag: str) -> dict:
    """After shutdown(): wait up to 20 s for the port's processes to go;
    raise if any is left."""
    deadline = time.monotonic() + 20
    left = _port_processes()
    while left and time.monotonic() < deadline:
        time.sleep(0.5)
        left = _port_processes()
    print(f"[{tag}] after shutdown(): port processes left {sorted(left)}", flush=True)
    if left:
        raise AssertionError(f"left after shutdown(): processes {left}")
    return left


def _pp_program(cfg, host: dict):
    """The GPT-2 stage programs starting from ``host`` (CPU tensors of the
    model's parameters)."""
    from ray_tpu_torch.train.sharding import gpt2_pipeline_programs

    return dataclasses.replace(gpt2_pipeline_programs(cfg, PP_STAGES, lr=TRAIN_LR),
                               init_params=functools.partial(dict, host))


def _pp_data_fn(rows: np.ndarray, marks: list = None, hook=None):
    def data_fn(step: int):
        if marks is not None:
            marks.append(time.perf_counter())
        if hook is not None:
            hook(step)
        b = rows[step * DATA_B:(step + 1) * DATA_B]
        return b[:, :-1], b[:, 1:]

    return data_fn


def _timed_methods(plane, names=("_distribute_state", "checkpoint", "_teardown")) -> dict:
    """Wrap ``names`` of ``plane`` to add up each one's wall seconds in the
    returned dict (where a plane's start, drill and restart spend it)."""
    spent = {}
    for name in names:
        def wrap(*a, _f=getattr(plane, name), _n=name, **kw):
            t = time.perf_counter()
            try:
                return _f(*a, **kw)
            finally:
                spent[_n] = spent.get(_n, 0.0) + time.perf_counter() - t
        setattr(plane, name, wrap)
    return spent


def _pp_rings() -> list:
    from ray_tpu_torch.experimental.channel import ring_base_dir

    return sorted(n for n in os.listdir(ring_base_dir()) if n.startswith("ray_tpu_torch_pp"))


def _pp_f32_parity(card: str, rows: np.ndarray) -> dict:
    """(a) GPT-2 medium's widths at PP_PARITY_LAYERS layers in f32: two
    stages on the card from the weights and rows of an unbroken,
    unpipelined f32 run in the driver; PP_PARITY_STEPS steps, each loss
    equal to the driver's to 1e-4 relative; then the kill drill (stage 1
    killed after step 3, a checkpoint every 2 steps, one restart that
    replays steps 3 to 4): every loss within 2e-5 absolute of the
    unbroken run's, the reference drill's limit."""
    from ray_tpu_torch.train.sharding import PipelineConfig, PipelinePlane

    cfg = dataclasses.replace(gpt2.GPT2Config.medium(dtype=torch.float32),
                              n_layer=PP_PARITY_LAYERS)
    model = gpt2.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    host = {k: v.detach().to("cpu", copy=True) for k, v in model.named_parameters()}
    step = gpt2.make_train_step(cfg, gpt2.make_adamw(model.parameters(), lr=TRAIN_LR))
    batches = torch.from_numpy(rows[:PP_DRILL_STEPS * DATA_B].astype(np.int64)).to("cuda")
    ref = [step(model, b[:, :-1], b[:, 1:]).item()
           for b in batches.view(PP_DRILL_STEPS, DATA_B, -1)]
    del model, step, batches
    torch.cuda.empty_cache()
    pcfg = PipelineConfig(stages=PP_STAGES, microbatches=PP_M, ring_capacity=PP_RING,
                          step_timeout_s=PP_STEP_TIMEOUT_S, checkpoint_every=2, max_restarts=1)
    data_fn = _pp_data_fn(rows)
    plane = PipelinePlane(_pp_program(cfg, host), pcfg)
    spent = _timed_methods(plane)
    t0 = time.perf_counter()
    try:
        plane.start()
        start_s = time.perf_counter() - t0
        part = plane.run(data_fn, PP_PARITY_STEPS)  # the checkpoint landed at step 2
        run_s = time.perf_counter() - t0 - start_s
        ray_tpu_torch.kill(plane.actors[1])  # step 3 is not checkpointed
        t1 = time.perf_counter()
        rest = plane.run(data_fn, PP_DRILL_STEPS)  # restarts, replays steps 3..4
        recover_s = time.perf_counter() - t1
        restarts = plane.restarts
    finally:
        t1 = time.perf_counter()
        plane.stop()
        stop_s = time.perf_counter() - t1
    drill = [part[i] if i < 2 else rest[i] for i in range(PP_DRILL_STEPS)]
    rels = [abs(a - b) / abs(b) for a, b in zip(part, ref)]
    drill_err = max(abs(a - b) for a, b in zip(drill, ref))
    res = {"ref_losses": ref, "losses": part, "drill_losses": drill,
           "loss_rel_err": max(rels), "drill_abs_err": drill_err, "restarts": restarts,
           "rings_after_stop": _pp_rings(),
           "seconds": {"start": start_s, "run": run_s, "kill_to_recovered": recover_s,
                       "stop": stop_s, **spent}}
    print(f"[pipeline] (a) GPT-2 medium widths, {PP_PARITY_LAYERS} layers, f32, B={DATA_B}, "
          f"T={TRAIN_T}, {PP_STAGES} stages x M={PP_M} on the card: losses {part} vs the "
          f"driver's unbroken unpipelined f32 run {ref}, max rel {max(rels):.2e} (tol 1e-4); "
          f"kill drill (stage 1 killed after step {PP_PARITY_STEPS}, checkpoint every 2): "
          f"restarts {restarts}, losses {drill}, max abs {drill_err:.2e} from the unbroken run's "
          f"(tol 2e-5); ring dirs after stop() {res['rings_after_stop']}; seconds "
          f"{ {k: round(v, 1) for k, v in res['seconds'].items()} } — {card}", flush=True)
    if max(rels) > 1e-4 or restarts != 1 or drill_err > 2e-5 or res["rings_after_stop"]:
        raise AssertionError(f"the f32 pipeline or its kill drill failed: {res}")
    return res


def _pp_main_path(card: str, data: dict) -> dict:
    """(b) GPT-2 medium (f32 params, bf16 compute, 24 layers) over two
    GPU stage actors sharing the card: phase 18's initial weights and
    rows, B=16 (M=4), T=1024, PP_STEPS steps through PipelinePlane.run;
    the launch counts set to 0 in the driver just before and read in each
    stage (fresh processes) just after."""
    from ray_tpu_torch.train.sharding import PipelineConfig, PipelinePlane

    cfg = gpt2.GPT2Config.medium(param_dtype=torch.float32)
    model = gpt2.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    host = {k: v.detach().to("cpu", copy=True) for k, v in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    nbytes = sum(t.numel() * t.element_size() for t in host.values())
    shm = shutil.disk_usage("/dev/shm")
    if shm.free < 2 * nbytes + 4 * PP_RING:
        raise AssertionError(f"/dev/shm has {shm.free / 1e9:.2f} GB free; the weight broadcast "
                             f"needs {2 * nbytes / 1e9:.2f} GB")
    leases = {}

    def look(step):  # mid-run: the stages hold their GPU leases
        if step == PP_STEPS // 2:
            from ray_tpu_torch.util.placement_group import placement_group_table

            leases["available_gpu"] = ray_tpu_torch.available_resources().get("GPU", 0.0)
            leases["cluster_gpu"] = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            leases["bundles"] = [[b["resources"] for b in pg["bundles"]]
                                 for pg in placement_group_table() if pg["state"] == "CREATED"]

    # (a)'s drill killed and restarted a stage: its processes give their
    # leases back as they exit, and this plane's placement group waits at
    # most 60 s for its bundles
    t_free = time.perf_counter()
    while True:
        free = {k: ray_tpu_torch.available_resources().get(k, 0.0) for k in ("CPU", "GPU")}
        total = {k: ray_tpu_torch.cluster_resources().get(k, 0.0) for k in ("CPU", "GPU")}
        if free == total:
            break
        if time.perf_counter() - t_free > 120:
            from ray_tpu_torch.util.placement_group import placement_group_table

            raise AssertionError(f"the cluster's CPU and GPU were not free 120 s after (a)'s "
                                 f"drill: {free} of {total}, placement groups "
                                 f"{placement_group_table()}")
        time.sleep(0.2)
    print(f"[pipeline] CPU and GPU free after (a): {time.perf_counter() - t_free:.2f} s",
          flush=True)
    marks = []
    plane = PipelinePlane(_pp_program(cfg, host), PipelineConfig(
        stages=PP_STAGES, microbatches=PP_M, ring_capacity=PP_RING, step_timeout_s=120.0))
    spent = _timed_methods(plane)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        plane.start()
        start_s = time.perf_counter() - t0
        losses = plane.run(_pp_data_fn(data["rows"], marks, look), PP_STEPS)
        marks.append(time.perf_counter())
        stats = plane.stage_stats()
        driver_launches = list(_launch_counts())
    finally:
        t1 = time.perf_counter()
        plane.stop()
        stop_s = time.perf_counter() - t1
    rings = _pp_rings()
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    step_ms = statistics.mean(step_s[PP_WARMUP:]) * 1e3
    tok_s = DATA_B * TRAIN_T / (step_ms / 1e3)
    mfu = tok_s * gpt2.flops_per_token(cfg, TRAIN_T) / PEAK_BF16_FLOPS
    per = cfg.n_layer // PP_STAGES
    want = [[2 * per * PP_M * PP_STEPS, per * PP_M * PP_STEPS, per * PP_M * PP_STEPS],
            [per * PP_M * PP_STEPS] * 3]  # stage 0 recomputes its forward in B
    raw = data["raw"]["losses"]
    first_rel = abs(losses[0] - raw[0]) / abs(raw[0])
    later = [abs(a - b) / abs(b) for a, b in zip(losses[1:], raw[1:PP_STEPS])]
    act_bytes = 2 * DATA_B * TRAIN_T * cfg.d_model * 4  # each microbatch's f32 frame down, its gradient up
    res = {"losses": losses, "raw_losses": raw[:PP_STEPS], "first_loss_rel_err": first_rel,
           "later_loss_rel_err": max(later), "step_ms_all": [x * 1e3 for x in step_s],
           "step_ms": step_ms, "tokens_per_s": tok_s, "mfu": mfu, "stats": stats,
           "launches_by_stage": [s["launches"] for s in stats], "want_launches": want,
           "driver_launches": driver_launches, "leases": leases,
           "activation_bytes_per_step": act_bytes, "rings_after_stop": rings,
           "shm_free_gb": shm.free / 1e9, "broadcast_gb": nbytes / 1e9,
           "seconds": {"start": start_s, "steps": marks[-1] - marks[0], "stop": stop_s, **spent}}
    print(f"[pipeline] (b) GPT-2 medium (f32 params, bf16 compute, 24 layers) over "
          f"PipelinePlane(stages={PP_STAGES}, microbatches={PP_M}) on the card, phase 18's "
          f"weights and rows: losses {[round(x, 5) for x in losses]}; step 1 vs phase 18's raw "
          f"first loss {raw[0]:.5f} rel {first_rel:.2e} (tol 1e-3), steps 2..{PP_STEPS} vs the "
          f"raw run's max rel {max(later):.2e} (tol {PP_LOSS_TOL:g}) — {card}", flush=True)
    print(f"[pipeline] (b) step {step_ms:.2f} ms (mean of steps {PP_WARMUP + 1}..{PP_STEPS}; all "
          f"{[round(x * 1e3, 1) for x in step_s]}) against phase 18's raw step "
          f"{data['raw']['step_ms']:.2f} ms (remat), {tok_s:.0f} tok/s, MFU {mfu:.4f}; per "
          f"stage busy s {[round(s['busy_s'], 3) for s in stats]}, wall s "
          f"{[round(s['wall_s'], 3) for s in stats]}, last step's bubble fraction "
          f"{[round(s['bubble_fraction'], 4) for s in stats]}, peak memory GB "
          f"{[round(s.get('peak_memory_gb', 0.0), 2) for s in stats]}; activations "
          f"{act_bytes / 1e6:.1f} MB a step over the rings; weight broadcast "
          f"{nbytes / 1e9:.2f} GB, /dev/shm free {shm.free / 1e9:.1f} GB; seconds "
          f"{ {k: round(v, 1) for k, v in res['seconds'].items()} } — {card}", flush=True)
    print(f"[pipeline] (b) launches B1/B2/B3 by stage {res['launches_by_stage']} (want {want}), "
          f"the driver's {driver_launches}; mid-run GPU available {leases.get('available_gpu')} "
          f"of {leases.get('cluster_gpu')}, bundles {leases.get('bundles')}; ring dirs after "
          f"stop() {rings}", flush=True)
    lease = {"CPU": 1.0, "GPU": 1.0 / PP_STAGES}
    if res["launches_by_stage"] != want or driver_launches != [0, 0, 0]:
        raise AssertionError(f"launches {res['launches_by_stage']} (want {want}), driver "
                             f"{driver_launches}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"pipeline losses not finite and falling: {losses}")
    if first_rel > 1e-3 or max(later) > PP_LOSS_TOL:
        raise AssertionError(f"pipeline losses {losses} vs raw {raw[:PP_STEPS]}")
    if (abs(leases.get("available_gpu", 1.0)) > 1e-9 or leases.get("cluster_gpu") != 1.0
            or leases.get("bundles") != [[lease] * PP_STAGES]):
        raise AssertionError(f"the stages' GPU leases: {leases}")
    if rings:
        raise AssertionError(f"ring dirs after stop(): {rings}")
    return res


def _pp_interleaved_grads(first, chunks, last, cfg, pp, v) -> dict:
    """The interleaved trees' gradients by the model's parameter names."""
    per = cfg.n_layer // (pp * v)
    out = {k: t.grad for k, t in (*first.items(), *last.items())}
    for name, t in chunks.items():
        for d in range(pp):
            for lap in range(v):
                for i in range(per):
                    out[f"h_{(d + lap * pp) * per + i}.{name}"] = t.grad[d, lap, i]
    return out


def _pp_spmd(card: str, rows: np.ndarray) -> dict:
    """(d) The SPMD pipeline on the card: GPT-2 medium's widths at 8
    layers, f32, B=4, T=1024; make_pp_loss_fn at pp=4, M=4 and
    make_pp_loss_fn_interleaved at pp=4, v=2, M=4 emulated on the card,
    and make_pp_loss_fn on a one-card {"pp": 1} mesh (the real-rank
    transport), each against the unpipelined f32 loss (1e-4 relative) and
    its gradients (each to 1e-3 of its tensor's largest entry)."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2_pp
    from ray_tpu_torch.parallel import create_mesh

    cfg = dataclasses.replace(gpt2.GPT2Config.medium(dtype=torch.float32), n_layer=8)
    model = gpt2.init_model(cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    toks = torch.from_numpy(rows[:4].astype(np.int64)).to("cuda")
    x, y = toks[:, :-1], toks[:, 1:]
    ref = gpt2.loss_fn(model, x, y)
    ref.backward()
    ref_grads = {n: p.grad for n, p in model.named_parameters()}
    params = {n: p.detach() for n, p in model.named_parameters()}

    def held(loss, grads) -> dict:
        return {"loss": loss.item(), "loss_rel_err": abs(loss.item() - ref.item()) / abs(ref.item()),
                "grad_err_over_max": max(_rel(grads[n], g)[1] for n, g in ref_grads.items())}

    def leaves(*trees):
        """Each tree with fresh leaf copies that collect gradients."""
        return [{k: t.detach().clone().requires_grad_(True) for k, t in tree.items()}
                for tree in trees]

    out = {"ref_loss": ref.item()}
    _reset_counts()
    sp, rest = leaves(*gpt2_pp.split_pipeline_params(params, cfg, 4))
    loss = gpt2_pp.make_pp_loss_fn(cfg, 4, n_micro=4)(sp, rest, x, y)
    loss.backward()
    out["emulated_pp4"] = held(loss, gpt2_pp.merge_pipeline_params(
        {k: t.grad for k, t in sp.items()}, {k: t.grad for k, t in rest.items()}, cfg))
    out["emulated_pp4"]["launches"] = list(_launch_counts())
    del sp, rest, loss
    first, chunks, last = leaves(*gpt2_pp.split_pipeline_params_interleaved(params, cfg, 4, 2))
    loss = gpt2_pp.make_pp_loss_fn_interleaved(cfg, 4, n_micro=4, n_virtual=2)(
        first, chunks, last, x, y)
    loss.backward()
    out["emulated_interleaved_pp4_v2"] = held(loss, _pp_interleaved_grads(first, chunks, last,
                                                                        cfg, 4, 2))
    del first, chunks, last, loss
    formed = not dist.is_initialized()
    mesh = create_mesh({"pp": 1}, device_type="cuda")
    try:
        sp, rest = leaves(*gpt2_pp.split_pipeline_params(params, cfg, 1))
        loss = gpt2_pp.make_pp_loss_fn(cfg, mesh, n_micro=4)(sp, rest, x, y)
        loss.backward()
        out["ranks_pp1"] = held(loss, gpt2_pp.merge_pipeline_params(
            {k: t.grad for k, t in sp.items()}, {k: t.grad for k, t in rest.items()}, cfg))
        out["ranks_pp1"]["backend"] = dist.get_backend(mesh.get_group("pp"))
    finally:
        if formed:
            dist.destroy_process_group()
    del model, params, ref_grads
    torch.cuda.empty_cache()
    print(f"[pipeline] (d) SPMD pipeline, GPT-2 medium widths at 8 layers, f32, B=4, T={TRAIN_T}, "
          f"unpipelined loss {out['ref_loss']:.6f}: emulated pp=4 M=4 {out['emulated_pp4']}; "
          f"emulated interleaved pp=4 v=2 M=4 {out['emulated_interleaved_pp4_v2']}; real-rank "
          f"transport on a one-card pp=1 mesh {out['ranks_pp1']} (tol: loss 1e-4 relative, "
          f"gradients 1e-3 of each tensor's max) — {card}", flush=True)
    for key in ("emulated_pp4", "emulated_interleaved_pp4_v2", "ranks_pp1"):
        if out[key]["loss_rel_err"] > 1e-4 or out[key]["grad_err_over_max"] > 1e-3:
            raise AssertionError(f"the SPMD pipeline ({key}) disagrees: {out[key]}")
    # 8 layers, 4 microbatches: B1 once a layer a microbatch, B2 and B3 as many
    if out["emulated_pp4"]["launches"] != [32, 32, 32]:
        raise AssertionError(f"emulated pipeline launches {out['emulated_pp4']['launches']}")
    return out


def phase_pipeline(card: str, data: dict) -> dict:
    """The pipeline planes: (a) the f32 parity and kill drill, (b) the
    slice's main path, bf16 GPT-2 medium over two GPU stage actors, under
    a cluster of their own; (c) B1, B2 and B3 at the microbatch's
    [4, 1024, 16, 64] bf16 causal, held against their plain versions and
    timed; (d) the SPMD pipeline on the card."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = {"card": card}
    parts = res["seconds_by_part"] = {}
    ctx = ray_tpu_torch.init(num_cpus=4)
    parts["init"] = time.perf_counter() - t0
    try:
        res["f32"] = _pp_f32_parity(card, data["rows"])
        parts["f32"] = time.perf_counter() - t0 - sum(parts.values())
        res["main"] = _pp_main_path(card, data)
        parts["main"] = time.perf_counter() - t0 - sum(parts.values())
    finally:
        ray_tpu_torch.shutdown()
    res["processes_left"] = _wait_no_port_processes("pipeline")
    # The stages wait on each other's rings by design (the 1F1B bubble, the
    # kill drill's wait): the GCS's gray-failure ladder must not read that
    # as a slow link, cordon the only node (SUSPECT) and quarantine it
    # under its own placement group.  The head's log names every such step.
    with open(os.path.join(ctx["session_dir"], "logs", "head.log"), errors="replace") as f:
        ladder = [ln.strip() for ln in f if " SUSPECT (score" in ln or " QUARANTINED (" in ln]
    res["suspect_or_quarantined"] = ladder
    print(f"[pipeline] the node's gray-failure ladder during (a) and (b): {len(ladder)} "
          f"line(s) of the head's log on SUSPECT or QUARANTINED — {card}", flush=True)
    if ladder:
        raise AssertionError(f"the pipeline's own blocked rings flapped its node: {ladder[:6]}")
    parts["shutdown"] = time.perf_counter() - t0 - sum(parts.values())

    # (c) the kernels at the microbatch: q/k/v views of the fused qkv
    cfg = gpt2.GPT2Config.medium()
    B, T, H, D = DATA_B // PP_M, TRAIN_T, cfg.n_head, cfg.d_head
    g = torch.Generator(device="cuda").manual_seed(600)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
    errs = _hold_bf16_kernels("pipeline kernels", "microbatch shape", "fused", q, k, v, do)
    recs = _time_bf16_kernels("pipeline kernels", "pipeline microbatch", q, k, v, do, errs, card,
                              sleep_cycles=50_000_000)
    by_stage = res["main"]["launches_by_stage"]
    for i, rec in enumerate(recs):
        rec["launches"] = sum(stage[i] for stage in by_stage)
        rec["launches_by_stage"] = [stage[i] for stage in by_stage]
    res["kernels"] = recs
    del q, k, v, do, qkv
    parts["kernels"] = time.perf_counter() - t0 - sum(parts.values())

    res["spmd"] = _pp_spmd(card, data["rows"])
    parts["spmd"] = time.perf_counter() - t0 - sum(parts.values())
    res["seconds"] = time.perf_counter() - t0
    print(f"[pipeline] phase took {res['seconds']:.1f} s: "
          f"{ {k: round(v, 1) for k, v in parts.items()} }", flush=True)
    print("[pipeline] " + json.dumps(res), flush=True)
    return res


# ----------------------------------------------------------------------
# Tune and RLlib: a Tuner sweeps GPT-2 small's TorchTrainer; PPO under a
# Tuner with its learner on the card; the Nature-CNN learner's update
# ----------------------------------------------------------------------
TUNE_LRS = (1e-4, 3e-4, 1e-3)  # the sweep's grid; 3e-4 is phase 9's lr
TUNE_STEPS = 4
# tests/test_rllib.py:90-116's configuration: 2 runners x 2 envs, batch
# 1024, minibatch 128, 6 epochs, entropy 0.01, seed 1
PPO_CONFIG = {"env": "CartPole-v1", "num_env_runners": 2, "num_envs_per_env_runner": 2,
              "num_cpus_per_env_runner": 1, "lr": 3e-4, "train_batch_size": 1024,
              "minibatch_size": 128, "num_epochs": 6, "entropy_coeff": 0.01, "seed": 1}
PPO_TARGET, PPO_MAX_ITERS = 120.0, 30
# the Nature-CNN at Atari's frame: conv ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
# hidden (512,), 84 x 84 x 4 uint8 frames, 1024 rows, minibatch 128, 2 epochs
CNN_FRAME, CNN_FILTERS, CNN_ACTIONS = (84, 84, 4), ((32, 8, 4), (64, 4, 2), (64, 3, 1)), 6
CNN_ROWS, CNN_MB, CNN_EPOCHS, CNN_LR = 1024, 128, 2, 3e-4


def _proc_start(pid: int):
    """Wall-clock start of process ``pid`` (``/proc/<pid>/stat``'s start
    time after boot, in clock ticks), or None once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    except (OSError, StopIteration, ValueError, IndexError):
        return None
    return boot + ticks / os.sysconf("SC_CLK_TCK")


class _ActorClock:
    """Polls the cluster's actor table from a thread of the driver, every
    ``period`` s: for each actor its class, its pid, the wall times it was
    first listed, first ALIVE and first DEAD, and its process's start."""

    def __init__(self, period: float = 0.05):
        import threading

        from ray_tpu_torch._private.worker import get_global_worker

        self._gcs = get_global_worker().gcs_client
        self._period, self.actors = period, {}
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True, name="actor-clock")
        self._thread.start()

    def _poll(self):
        while not self._done.is_set():
            now = time.time()
            for a in self._gcs.call("list_actors", None):
                rec = self.actors.setdefault(a["actor_id"], {"cls": a["class_name"], "seen": now})
                if a.get("pid") and "pid" not in rec:
                    rec["pid"] = a["pid"]
                    rec["proc_start"] = _proc_start(a["pid"])
                rec.setdefault(a["state"], now)
            self._done.wait(self._period)

    def stop(self) -> list:
        """The records, oldest first."""
        self._done.set()
        self._thread.join(timeout=5)
        return sorted(self.actors.values(), key=lambda r: r["seen"])


def _trial_startup(dispatch: float, arrival: float, runner: dict, worker: dict,
                   stamps: dict) -> dict:
    """One Tune trial's seconds from its dispatch (the sweep's start or the
    previous trial's report at the driver) to its own report there, split
    at the trial actor's and the trainer worker's process starts and the
    loop's stamps (``gpt2_loop``'s ``timeline``)."""
    actor_up = max(dispatch, runner.get("proc_start") or dispatch)
    worker_up = max(worker["seen"], worker.get("proc_start") or worker["seen"])
    return {
        "trial actor process": actor_up - dispatch,
        "trial actor to its worker's lease": worker["seen"] - actor_up,
        "worker process start": worker_up - worker["seen"],
        "worker to its loop (runtime, config)": stamps["loop"] - worker_up,
        "import torch and the model": stamps["imports"] - stamps["loop"],
        "CUDA context": stamps["device"] - stamps["imports"],
        "process group": 0.0,  # one worker: the backend forms no group
        "model init (AdamW imports torch._dynamo)": stamps["model"] - stamps["device"],
        "steps": stamps["steps"] - stamps["model"],
        "report to the driver": arrival - stamps["steps"],
        "teardown: worker gone": worker.get("DEAD", arrival) - arrival,
        "teardown: trial actor gone": runner.get("DEAD", arrival) - arrival,
    }


def _tune_sweep(card: str, raw: dict, storage: str) -> dict:
    """(a) Tuner(TorchTrainer(gpt2 loop)) over phase 9's GPT-2 small batch
    and seed, lr in TUNE_LRS, TUNE_STEPS steps each, one trial at a time,
    ASHA on the reported loss.  Each trial's fit() runs in its trial actor
    and its worker leases the card; the launches are counted in each
    worker (fresh processes, from 0)."""
    from ray_tpu_torch import tune

    arrivals = {}

    def arrived(result):  # the driver reads each trial's one report
        arrivals[result["config"]["train_loop_config"]["lr"]] = time.time()
        return False

    # phase 9's model, as keywords: the trial actor unpickles them without torch
    cfg_spec = {"size": "small", "dtype": "bfloat16", "param_dtype": "float32", "remat": False}
    cfg = model_config(cfg_spec)
    toks = np.random.default_rng(4).integers(0, PROMPT_VOCAB, size=(TRAIN_B, TRAIN_T + 1))
    trainer = TorchTrainer(
        train_loop_per_worker,
        train_loop_config={"cfg": cfg_spec, "seed": 0, "tokens": toks, "warmup": 0,
                           "steps": TUNE_STEPS, "device": "cuda", "peak_flops": PEAK_BF16_FLOPS},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(storage_path=os.path.join(storage, "train")),
    )
    tuner = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search(list(TUNE_LRS))}},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(max_t=TUNE_STEPS, grace_period=1, reduction_factor=2)),
        run_config=RunConfig(name="gpt2_sweep", storage_path=storage, stop=arrived),
    )
    _reset_counts()  # the driver's counts: they must stay 0 while the trials train
    clock = _ActorClock()
    t0 = time.time()
    results = tuner.fit()
    wall = time.time() - t0
    actors = clock.stop()
    # each trial's wall: from the previous trial's report (or the sweep's
    # start) to its own, which comes once its fit() returned
    order = sorted(arrivals, key=arrivals.get)
    marks = [t0] + [arrivals[lr] for lr in order]
    trial_s = dict(zip(order, (b - a for a, b in zip(marks, marks[1:]))))
    driver = list(_launch_counts())
    trials = {}
    for r in results:
        m = r.metrics or {}
        lr = m.get("config", {}).get("train_loop_config", {}).get("lr")
        trials[lr] = {k: m.get(k) for k in ("losses", "loss", "launches", "step_ms", "pid",
                                             "device_name", "tokens_per_s", "peak_memory_gb",
                                             "timeline")}
        trials[lr]["trial_s"] = trial_s.get(lr)
    runners = [a for a in actors if a["cls"].endswith("._TrialRunner")]
    workers = {a.get("pid"): a for a in actors if a["cls"].endswith(".RayTrainWorker")}
    for i, lr in enumerate(order):
        split = _trial_startup(marks[i], marks[i + 1], runners[i], workers[trials[lr]["pid"]],
                               trials[lr]["timeline"])
        trials[lr]["startup_s"] = split
        print(f"[timing] tune trial lr={lr:g} ({trial_s[lr]:.1f} s from the previous report; "
              f"the config imported torch before the loop: "
              f"{trials[lr]['timeline']['torch_preloaded']}): "
              + ", ".join(f"{k} {v:.2f} s" for k, v in split.items()), flush=True)
    best = results.get_best_result()
    best_lr = best.metrics["config"]["train_loop_config"]["lr"]
    want = [cfg.n_layer * TUNE_STEPS] * 3
    ref = raw["losses"][:TUNE_STEPS]
    mine = trials.get(TRAIN_LR, {}).get("losses") or []
    rels = [abs(a - b) / abs(b) for a, b in zip(mine, ref)]
    train_s = sum(TUNE_STEPS * (t["step_ms"] or 0) / 1e3 for t in trials.values())
    res = {"trials": trials, "best_lr": best_lr, "best_loss": best.metrics["loss"],
           "errors": results.num_errors, "sweep_s": wall,
           "trial_overhead_s": (wall - train_s) / max(1, len(trials)),
           "driver_launches": driver, "want_launches": want,
           "loss_rel_err_vs_raw": max(rels) if rels else None}
    for lr, t in sorted(trials.items()):
        print(f"[tune+rllib] (a) trial lr={lr:g}: losses {[round(x, 5) for x in t['losses'] or []]}, "
              f"step {t['step_ms']:.2f} ms (the first cold), trial {t['trial_s']:.1f} s from the "
              f"previous report, launches in its worker (pid {t['pid']}) B1/B2/B3 "
              f"{t['launches']} (want {want}) — {card}", flush=True)
    print(f"[tune+rllib] (a) Tuner(TorchTrainer) GPT-2 small B={TRAIN_B} T={TRAIN_T}, lr "
          f"{list(TUNE_LRS)}, {TUNE_STEPS} steps a trial, max_concurrent_trials=1, ASHA on loss: "
          f"ResultGrid's best trial lr={best_lr:g} loss {best.metrics['loss']:.5f}; the lr "
          f"{TRAIN_LR:g} trial vs phase 9's direct run (same seed and batch) max rel "
          f"{res['loss_rel_err_vs_raw']} (tol 1e-5); sweep {wall:.1f} s, "
          f"{res['trial_overhead_s']:.1f} s a trial outside its steps; the driver's launches "
          f"{driver} — {card}", flush=True)
    if results.num_errors or sorted(trials) != sorted(TUNE_LRS):
        raise AssertionError(f"the sweep's trials: {sorted(trials)}, errors {results.num_errors}")
    for lr, t in trials.items():
        if t["launches"] != want or not all(math.isfinite(x) for x in t["losses"]):
            raise AssertionError(f"trial lr={lr}: launches {t['launches']} (want {want}), "
                                 f"losses {t['losses']}")
    if driver != [0, 0, 0] or len({t["pid"] for t in trials.values()}) != len(trials):
        raise AssertionError(f"the trials did not train in workers of their own: driver "
                             f"{driver}, pids {[t['pid'] for t in trials.values()]}")
    if len(mine) != TUNE_STEPS or max(rels) > 1e-5:
        raise AssertionError(f"the lr {TRAIN_LR} trial's losses {mine} != the direct run's {ref}")
    if best.metrics["loss"] != min(t["loss"] for t in trials.values()):
        raise AssertionError(f"the ResultGrid's best trial {best_lr} is not the lowest loss")
    return res


def _weights_sum(weights: dict) -> float:
    """A float64 fingerprint of a learner's weights."""
    return float(sum(np.sum(v, dtype=np.float64) for _, v in sorted(weights.items())))


def _smoke_ppo_class():
    """PPO whose results add the trial's pid, its env runners' pids, the
    learner's device, the learner's update seconds an iteration and a
    fingerprint of the weights (defined here, pickled by value)."""
    from ray_tpu_torch.rllib import PPO

    class SmokePPO(PPO):
        def setup(self, config):
            super().setup(config)
            update = self.learner_group.update_from_batch
            self._update_s = []

            def timed(*a, **kw):
                t = time.perf_counter()
                out = update(*a, **kw)  # its metrics are read back: the card has finished
                self._update_s.append(time.perf_counter() - t)
                return out

            self.learner_group.update_from_batch = timed

        def step(self):
            out = super().step()
            out["pid"] = os.getpid()
            states = ray_tpu_torch.get([r.__ray_call__.remote(_cuda_state)
                                        for r in self.env_runner_group.runners])
            out["runner_pids"] = [pid for pid, _ in states]
            out["runner_cuda_context"] = [ctx for _, ctx in states]
            out["learner_device"] = str(self.learner_group._local.device)
            out["learner_update_s"] = self._update_s[-1]
            out["weights_sum"] = _weights_sum(self.learner_group.get_weights())
            return out

    return SmokePPO


def _ppo_under_tune(card: str, storage: str) -> dict:
    """(b) PPO on CartPole-v1 under Tuner(tune.with_resources(PPO, {"cpu":
    1, "gpu": 1})): the learner updates on cuda inside the trial actor, the
    env runners infer on their CPUs; stop past PPO_TARGET or after
    PPO_MAX_ITERS; the trial's checkpoint restores equal weights."""
    from ray_tpu_torch import tune

    ppo = _smoke_ppo_class()
    seen = {"iters": [], "maps": {}, "uvm": {}}

    def stop(r):  # the driver reads each result while the trial's processes live
        seen["iters"].append({k: r.get(k) for k in (
            "training_iteration", "episode_return_mean", "num_env_steps_sampled",
            "time_this_iter_s", "learner_update_s", "learner_device", "weights_sum")})
        for pid in [r["pid"], *r["runner_pids"]]:
            seen["maps"].setdefault(pid, _maps_libcuda(pid))
            seen["uvm"][pid] = seen["uvm"].get(pid, False) or _maps_uvm(pid)
        seen["pids"] = (r["pid"], list(r["runner_pids"]))
        seen["runner_cuda_context"] = seen.get("runner_cuda_context", False) or any(
            r["runner_cuda_context"])
        return ((r.get("episode_return_mean") or 0.0) > PPO_TARGET
                or r["training_iteration"] >= PPO_MAX_ITERS)

    tuner = tune.Tuner(
        tune.with_resources(ppo, {"cpu": 1, "gpu": 1}),
        param_space=dict(PPO_CONFIG),
        tune_config=tune.TuneConfig(metric="episode_return_mean", mode="max"),
        run_config=RunConfig(name="ppo_cartpole", storage_path=storage, stop=stop),
    )
    t0 = time.perf_counter()
    results = tuner.fit()
    wall = time.perf_counter() - t0
    best = results.get_best_result()
    iters = seen["iters"]
    last = iters[-1]
    trial_pid, runner_pids = seen["pids"]
    rates = [i["num_env_steps_sampled"] / i["time_this_iter_s"] for i in iters]
    updates = [i["learner_update_s"] for i in iters]
    # restore in the driver from the trial's last checkpoint
    restored = ppo.from_checkpoint(best.checkpoint.path)
    try:
        restored_sum = _weights_sum(restored.get_policy_weights())
        restored_device = str(restored.learner_group._local.device)
    finally:
        restored.cleanup()
    res = {"iterations": len(iters), "returns": [i["episode_return_mean"] for i in iters],
           "env_steps_per_s": rates, "env_steps_per_s_mean": statistics.mean(rates),
           "learner_update_ms": [u * 1e3 for u in updates],
           "learner_update_ms_mean": statistics.mean(updates) * 1e3,
           "learner_device": last["learner_device"], "trial_pid": trial_pid,
           "runner_pids": runner_pids, "maps_libcuda": seen["maps"], "wall_s": wall,
           "weights_sum": last["weights_sum"], "restored_weights_sum": restored_sum,
           "restored_device": restored_device, "errors": results.num_errors}
    print(f"[tune+rllib] (b) Tuner(with_resources(PPO, cpu 1, gpu 1)) on CartPole-v1, "
          f"{PPO_CONFIG}: episode_return_mean by iteration "
          f"{[round(x or 0.0, 1) for x in res['returns']]} (want > {PPO_TARGET:g}); learner on "
          f"{last['learner_device']}; env-steps/s {res['env_steps_per_s_mean']:.0f} (by iteration "
          f"{[round(x) for x in rates]}); learner update {res['learner_update_ms_mean']:.1f} ms an "
          f"iteration ({PPO_CONFIG['num_epochs']} epochs x "
          f"{PPO_CONFIG['train_batch_size'] // PPO_CONFIG['minibatch_size']} minibatches); "
          f"libcuda mapped: trial {trial_pid} {seen['maps'].get(trial_pid)}, runners "
          f"{ {p: seen['maps'].get(p) for p in runner_pids} } (import torch maps it); a CUDA "
          f"context in a runner {seen['runner_cuda_context']}, /dev/nvidia-uvm mapped: trial "
          f"{seen['uvm'].get(trial_pid)}, runners { {p: seen['uvm'].get(p) for p in runner_pids} }; "
          f"restored weights sum "
          f"{restored_sum!r} vs the trial's {last['weights_sum']!r}; {wall:.1f} s — {card}",
          flush=True)
    if results.num_errors or not (last["episode_return_mean"] or 0.0) > PPO_TARGET:
        raise AssertionError(f"PPO did not pass {PPO_TARGET}: {res}")
    if not last["learner_device"].startswith("cuda") or not restored_device.startswith("cuda"):
        raise AssertionError(f"the learner did not update on the card: {res}")
    if (not (seen["maps"][trial_pid] and seen["uvm"][trial_pid]) or seen["runner_cuda_context"]
            or any(seen["uvm"][p] for p in runner_pids)):
        raise AssertionError(f"no CUDA context in the trial actor, or one in an env runner: "
                             f"{seen}")
    if restored_sum != last["weights_sum"]:
        raise AssertionError(f"the restored weights differ from the trial's: {res}")
    return res


def _cnn_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.integers(0, 256, size=(CNN_ROWS, int(np.prod(CNN_FRAME))), dtype=np.uint8),
        "actions": rng.integers(0, CNN_ACTIONS, size=CNN_ROWS),
        "action_logp": (np.log(1.0 / CNN_ACTIONS) + 0.1 * rng.standard_normal(CNN_ROWS)
                        ).astype(np.float32),
        "advantages": rng.standard_normal(CNN_ROWS).astype(np.float32),
        "value_targets": rng.standard_normal(CNN_ROWS).astype(np.float32),
    }


def _opt_hooks(optimizers: dict):
    """Record each optimizer's first step (its gradients before it, its
    parameters after it) and count its steps, by ``{key: (optimizer,
    [(name, param)])}``; returns the record and a function that removes
    the hooks."""
    rec, hooks = {}, []
    for key, (opt, named) in optimizers.items():
        slot = rec.setdefault(key, {"steps": 0})

        def pre(o, a, kw, slot=slot, named=named):
            slot.setdefault("grads", {n: p.grad.detach().cpu().clone()
                                      for n, p in named if p.grad is not None})

        def post(o, a, kw, slot=slot, named=named):
            slot.setdefault("params", {n: p.detach().cpu().clone() for n, p in named})
            slot["steps"] += 1

        hooks += [opt.register_step_pre_hook(pre), opt.register_step_post_hook(post)]
    return rec, lambda: [h.remove() for h in hooks]


def _loss_hook(obj, method: str):
    """Record the loss of each call of ``obj.method`` (a minibatch's, a
    fragment's: each is one Adam step's) and the first call's inputs;
    returns the record and a function that restores the method."""
    rec = {"losses": []}
    loss_of = getattr(obj, method)

    def recorded(*args):
        out = loss_of(*args)
        rec.setdefault("args", args)
        rec["losses"].append(out[0].detach())
        return out

    setattr(obj, method, recorded)
    return rec, lambda: delattr(obj, method)  # the class's method again


def _each(run):
    """``run_all`` for learners that each take their updates alone."""
    return lambda learners: {key: run(learner) for key, learner in learners.items()}


def _learner_optimizers(learner) -> dict:
    return {"module": (learner.optimizer, _named(learner.module))}


def _named(module) -> list:
    return list(module.named_parameters())


def _fmt(d: dict) -> dict:
    return {k: f"{v:.1e}" for k, v in d.items()}


def _hold_updates(tag: str, card: str, make, optimizers_of, run_all, lrs: dict,
                  first_tol=lambda metric: 1e-4, loss_of=None, f64_grads=None) -> dict:
    """The same updates on the card, on the CPU and on the CPU from weights
    moved by 1e-6 relative (the CPU's own spread).  ``make(device)``
    builds a learner (or an algorithm that holds one),
    ``optimizers_of(it)`` names its optimizers and their parameters,
    ``run_all(them)`` runs every one's updates and returns each one's
    metrics an update.  Where an update takes many Adam steps,
    ``loss_of(it)`` gives the object and method whose loss each step
    descends.  Held:

    - the first update's metrics to ``first_tol(metric)`` relative, or
      twice the CPU's own spread where that is wider (an update of many
      steps reports its last minibatch's metrics, which drift as its
      losses do: PPO's mean_kl and grad_norm by 7.6e-2 and 4.0e-2 on the
      CPU alone for weights moved 1e-6);
    - each optimizer's first step by phase 8's rule: its loss to 1e-4
      relative (where ``loss_of`` names it), the gradients to 1e-3 of
      each tensor's max (``f64_grads``' fallback is explained below), each
      parameter after it within 1e-2 lr where its gradient is at least
      1e-2 of its tensor's largest, else within 2 lr and two f32 spacings
      of the largest parameter (p + lr and p - lr, rounded);
    - every step's loss (``loss_of``'s, else each update's loss metrics)
      to CNN_LOSS_TOL, the CPU's own spread printed beside it;
    - every parameter at the end within 2 lr a step of its optimizer;
    - all finite.

    Returns the numbers and, under "learners", what ``make`` built."""
    learners = {key: make(key.rstrip("+")) for key in ("cuda", "cpu", "cpu+")}
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for _, named in optimizers_of(learners["cpu+"]).values():
            for _, p in named:
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=g))
        if hasattr(learners["cpu+"], "old_params"):  # APPO's target policy
            learners["cpu+"].old_params = learners["cpu+"]._copy_params()
    recs = {key: _opt_hooks(optimizers_of(learner)) for key, learner in learners.items()}
    losses = {key: _loss_hook(*loss_of(learner)) for key, learner in learners.items()} \
        if loss_of else {}
    t = time.perf_counter()
    metrics = run_all(learners)
    held_s = time.perf_counter() - t
    for _, stop in [*recs.values(), *losses.values()]:
        stop()
    first = {k: _rel_err(v, metrics["cpu"][0][k]) for k, v in metrics["cuda"][0].items()}
    first_spread = {k: _rel_err(metrics["cpu+"][0][k], v) for k, v in metrics["cpu"][0].items()}
    if loss_of:
        step_losses = {key: [x.item() for x in rec["losses"]] for key, (rec, _) in losses.items()}

        def loss_rel(key):
            return [abs(a - b) / abs(b) for a, b in zip(step_losses[key], step_losses["cpu"])]
    else:
        names = [k for k in metrics["cpu"][0] if "loss" in k]
        step_losses = {key: [m[k] for m in ms for k in names] for key, ms in metrics.items()}

        def loss_rel(key):
            return [_rel_err(m[k], c[k]) for m, c in zip(metrics[key], metrics["cpu"])
                    for k in names]
    rels, spread = loss_rel("cuda"), max(loss_rel("cpu+"))
    on_card, on_cpu = recs["cuda"][0], recs["cpu"][0]
    grad_errs, f64, step1_sure, step1_all, ulps, steps = {}, {}, {}, {}, {}, {}
    for key, slot in on_cpu.items():
        card_slot = on_card[key]
        grad_errs[key] = {n: float((card_slot["grads"][n] - gr).abs().max()
                                   / gr.abs().max().clamp_min(1e-30))
                          for n, gr in slot["grads"].items()}
        sure = {n: gr.abs() >= 1e-2 * gr.abs().max() for n, gr in slot["grads"].items()}
        step1_sure[key] = max(float((card_slot["params"][n] - p).abs()[sure[n]].max())
                              if n in sure and sure[n].any() else 0.0
                              for n, p in slot["params"].items())
        step1_all[key] = max(float((card_slot["params"][n] - p).abs().max())
                             for n, p in slot["params"].items())
        ulps[key] = 2 * max(float(np.spacing(np.float32(p.abs().max())))
                            for p in slot["params"].values())
        steps[key] = slot["steps"]
    # A tensor whose gradient sums terms that cancel heavily can leave an
    # f32 sum farther than 1e-3 of its max from the exact value (APPO's
    # first step on the pi torso's convolutions: the CPU's f32 1.4e-3 to
    # 7.6e-3 off its float64 gradient, the card's 1e-6 to 1.6e-3).  Where
    # ``f64_grads(first step's inputs)`` is given and card and CPU part by
    # more than 1e-3, the card is held to the float64 gradient of the same
    # step instead: within 1e-3 of its max, or no farther than twice the
    # CPU's own f32.
    if f64_grads and any(e > 1e-3 for errs in grad_errs.values() for e in errs.values()):
        g64 = f64_grads(losses["cuda"][0]["args"])
        for key, errs in grad_errs.items():
            for n in (n for n, e in errs.items() if e > 1e-3 and n in g64):
                mx = g64[n].abs().max()
                f64[n] = {"card": float((on_card[key]["grads"][n].double() - g64[n]).abs().max()
                                        / mx),
                          "cpu_f32": float((on_cpu[key]["grads"][n].double() - g64[n]).abs().max()
                                           / mx)}
    grads_held = all(e <= 1e-3 or (n in f64 and f64[n]["card"] <= max(1e-3, 2 * f64[n]["cpu_f32"]))
                     for errs in grad_errs.values() for n, e in errs.items())
    grad_err = {key: max(errs.values()) for key, errs in grad_errs.items()}
    final = {key: {k: dict(named) for k, (_, named) in optimizers_of(learner).items()}
             for key, learner in learners.items()}

    def param_diff(key):
        return {k: max(float((final[key][k][n].detach().cpu() - p.detach()).abs().max())
                       for n, p in named.items()) for k, named in final["cpu"].items()}

    param_err, param_spread = param_diff("cuda"), param_diff("cpu+")
    out = {"updates": len(metrics["cpu"]), "adam_steps": steps, "losses_cuda": step_losses["cuda"],
           "losses_cpu": step_losses["cpu"], "first_metrics_rel_err": first,
           "cpu_spread_first_metrics_rel": first_spread, "first_grad_err_over_max": grad_err,
           "first_grads_vs_f64": f64, "first_step_param_err_sure": step1_sure,
           "first_step_param_err": step1_all, "loss_rel_err": max(rels),
           "cpu_spread_loss_rel": spread, "param_err": param_err,
           "cpu_spread_param": param_spread, "lrs": lrs, "held_s": held_s,
           "metrics_cuda": metrics["cuda"][-1], "metrics_cpu": metrics["cpu"][-1]}
    first_loss = f"step 1 loss rel {rels[0]:.2e} (tol 1e-4); " if loss_of else ""
    f64_note = "".join(f"; {n} {f['card']:.2e} of max from its f64 gradient (tol 1e-3 or "
                       f"twice the CPU's f32 {f['cpu_f32']:.2e})" for n, f in f64.items())
    print(f"{tag} card vs CPU, f32, {out['updates']} update(s), Adam steps {steps}: {first_loss}"
          f"gradients of the first step {_fmt(grad_err)} of max (tol 1e-3{f64_note}); params "
          f"after it {_fmt(step1_sure)} where |g| >= 1e-2 max|g| (tol 1e-2 lr, lr {lrs}), "
          f"{_fmt(step1_all)} overall (tol 2 lr + {_fmt(ulps)}); the first update's metrics "
          f"{_fmt(first)} (tol {', '.join(sorted({f'{first_tol(k):g}' for k in first}))} or twice "
          f"the CPU's own for weights moved 1e-6: {_fmt(first_spread)}); every loss max rel "
          f"{max(rels):.2e} (tol {CNN_LOSS_TOL:g}; the CPU's own {spread:.2e}); params at the "
          f"end {_fmt(param_err)} (tol 2 lr a step; the CPU's own {_fmt(param_spread)}) — {card}",
          flush=True)
    finite = all(math.isfinite(x) for x in step_losses["cuda"]) and all(
        math.isfinite(v) for m in metrics["cuda"] for v in m.values())
    ok = (all(v <= max(first_tol(k), 2 * first_spread[k]) for k, v in first.items())
          and (not loss_of or rels[0] <= 1e-4) and grads_held
          and all(step1_sure[k] <= 1e-2 * lrs[k] for k in step1_sure)
          and all(step1_all[k] <= 2 * lrs[k] + ulps[k] for k in step1_all)
          and max(rels) <= CNN_LOSS_TOL
          and all(param_err[k] <= 2 * lrs[k] * steps[k] + ulps[k] for k in param_err)
          and finite)
    if not ok:
        raise AssertionError(f"{tag}: the card's updates disagree with the CPU's: {out}")
    return {**out, "learners": learners}


# The whole update's minibatch losses, card vs CPU.  Adam's steps amplify
# rounding: an entry whose gradient sits at rounding level moves by about
# lr either way, and later minibatches' losses follow.  On the CPU alone a
# 1e-6 relative change of the initial weights moved these losses by 1.4e-4
# to 1.3e-3 relative over the 16 steps (the run prints its own spread);
# 5e-3 bounds that drift, where a 10% error in lr or the clip moves some
# minibatch's loss by 0.05 to 0.15 (the same update on the CPU).
CNN_LOSS_TOL = 5e-3


def _cnn_learner(card: str) -> dict:
    """(c) PPO's learner with the Nature-CNN torso at Atari's frame: one
    update_from_batch_epochs (CNN_EPOCHS x CNN_ROWS // CNN_MB Adam steps)
    in f32 on the card and on the CPU from the same seed (the same
    weights and permutations), held by ``_hold_updates`` (the last
    minibatch's metrics to CNN_LOSS_TOL or twice the CPU's spread).  Then
    the card's update, timed."""
    from ray_tpu_torch.rllib import SampleBatch
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner

    conf = {"lr": CNN_LR, "clip_param": 0.2, "vf_clip_param": 10.0, "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01, "seed": 0}
    batch = SampleBatch(_cnn_batch(21))
    res = _hold_cnn(f"[tune+rllib] (c) PPO learner, Nature-CNN {CNN_FILTERS} + (512,) on "
                    f"{CNN_FRAME} uint8 frames, {CNN_ROWS} rows, minibatch {CNN_MB}, "
                    f"{CNN_EPOCHS} epochs,", card, PPOLearner, conf, "compute_loss",
                    lambda lrn: [lrn.update_from_batch_epochs(batch, CNN_MB, CNN_EPOCHS)],
                    CNN_LOSS_TOL, f64=False)
    learner = res.pop("learners")["cuda"]
    res["n_params"] = sum(p.numel() for p in learner.module.parameters())
    # the update on the card, timed: three more (the first held the warm-up)
    res["update_ms_all"] = _time_card(
        lambda: learner.update_from_batch_epochs(batch, CNN_MB, CNN_EPOCHS), reps=3)
    res["update_ms"] = statistics.median(res["update_ms_all"])
    print(f"[tune+rllib] (c) PPO learner's update ({res['n_params']} parameters, "
          f"{res['adam_steps']['module']} Adam steps) on the card: {res['update_ms']:.2f} ms "
          f"(runs {[round(x, 2) for x in res['update_ms_all']]}; the three learners held took "
          f"{res['held_s']:.2f} s with the card's warm-up) — {card}", flush=True)
    return res


def _hold_cnn(tag: str, card: str, learner_cls, conf: dict, method: str, run, first_tol: float,
              f64: bool = True) -> dict:
    """``_hold_updates`` for a Nature-CNN learner of ``learner_cls`` whose
    Adam steps descend ``method``'s loss, ``run(learner)`` giving each
    update's metrics; ``f64``: fall back to the first step's float64
    gradients where card and CPU part."""
    return _hold_updates(tag, card, lambda d: learner_cls(_cnn_spec(), {**conf, "device": d}),
                         _learner_optimizers, _each(run), {"module": conf["lr"]},
                         lambda metric: first_tol, loss_of=lambda lrn: (lrn, method),
                         f64_grads=functools.partial(_f64_grads, learner_cls, conf, method)
                         if f64 else None)


# ----------------------------------------------------------------------
# The podracer plane at the Nature-CNN's widths: IMPALA's, APPO's and
# PPO's fragment updates on the card against the CPU, the sebulba
# inference server on the card, and the streaming loop where gymnasium is
# installed
# ----------------------------------------------------------------------
FRAG_T, FRAG_N = 50, 8  # IMPALAConfig's rollout_fragment_length x 8 envs: 400 rows
FRAG_UPDATES = 8
APPO_UPDATES = 4  # target_network_update_freq 2: the target syncs after updates 2 and 4
PPO_K, PPO_MB, PPO_EPOCHS = 4, 128, 2  # 1600 rows: 12 minibatches x 2 epochs
FRAG_TIMED = 5  # timed updates on the card after the held ones
# IMPALAConfig's, APPOConfig's and PPOConfig's defaults
IMPALA_CONF = {"lr": 5e-4, "gamma": 0.99, "vtrace_clip_rho": 1.0, "vtrace_clip_c": 1.0,
               "vf_loss_coeff": 0.5, "entropy_coeff": 0.01, "seed": 0}
APPO_CONF = {**IMPALA_CONF, "clip_param": 0.4, "use_kl_loss": False, "kl_coeff": 1.0,
             "target_network_update_freq": 2}
PPO_FRAG_CONF = {"lr": 3e-4, "gamma": 0.99, "lambda_": 0.95, "clip_param": 0.3,
                 "vf_clip_param": 10.0, "vf_loss_coeff": 0.5, "entropy_coeff": 0.0, "seed": 0}
SEBULBA_CALLERS, SEBULBA_CALLS, SEBULBA_B = 4, 16, 8
SEBULBA_GEN = 3
# tests/test_rllib_podracer.py's IMPALA configuration
PODRACER_LOOP = {"num_env_runners": 2, "num_envs_per_env_runner": 4, "lr": 5e-4,
                 "rollout_fragment_length": 32, "seed": 3, "iterations": 4}


def _cnn_spec():
    from ray_tpu_torch.rllib import RLModuleSpec

    return RLModuleSpec(observation_dim=int(np.prod(CNN_FRAME)), action_dim=CNN_ACTIONS,
                        hidden=(512,), obs_shape=CNN_FRAME, conv_filters=CNN_FILTERS)


def _cnn_fragment(seed: int) -> dict:
    """One [FRAG_T, FRAG_N] fragment as a runner writes it at Atari's
    frame: uint8 frames, int64 actions, one termination (env 3, t = 20)
    and its autoreset row (loss mask 0), float32 the rest."""
    rng = np.random.default_rng(seed)
    T, N = FRAG_T, FRAG_N
    term = np.zeros((T, N), bool)
    term[20, 3] = True
    mask = np.ones((T, N), np.float32)
    mask[21, 3] = 0.0
    return {"cols": {
        "obs": rng.integers(0, 256, size=(T, N) + CNN_FRAME, dtype=np.uint8),
        "actions": rng.integers(0, CNN_ACTIONS, size=(T, N)),
        "rewards": rng.standard_normal((T, N)).astype(np.float32),
        "terminateds": term, "truncateds": np.zeros((T, N), bool),
        "action_logp": (np.log(1.0 / CNN_ACTIONS) + 0.1 * rng.standard_normal((T, N))
                        ).astype(np.float32),
        "vf_preds": rng.standard_normal((T, N)).astype(np.float32),
        "loss_mask": mask,
    }, "last_values": rng.standard_normal(N).astype(np.float32), "env_steps": int(mask.sum())}


def _env_major(frag: dict):
    """A fragment as the flat time-ordered batch a runner's sample()
    gives IMPALA's and APPO's learner thread: each env's T rows in turn."""
    from ray_tpu_torch.rllib import SampleBatch

    return SampleBatch({k: np.ascontiguousarray(np.swapaxes(v, 0, 1)).reshape(
        (FRAG_T * FRAG_N,) + v.shape[2:]) for k, v in frag["cols"].items()})


def _rel_err(got, want, floor: float = 1e-3) -> float:
    return abs(got - want) / max(abs(want), floor)


def _f64_grads(learner_cls, conf: dict, method: str, args) -> dict:
    """The first Adam step's gradients in float64 on the CPU: the same
    initial weights (the learners' seed draws them in float32), the card
    learner's first-step inputs."""
    learner = learner_cls(dataclasses.replace(_cnn_spec(), dtype=torch.float64),
                          {**conf, "device": "cpu"})

    def host(v):
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        v = v.detach().cpu()
        return v.double() if v.is_floating_point() else v

    loss, _ = getattr(learner, method)(*[host(a) for a in args])
    loss.backward()
    return {n: p.grad for n, p in learner.module.named_parameters()}


def _time_card(update, reps: int = FRAG_TIMED) -> list:
    """ms of ``update()`` on the card, each run synchronised."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        update()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def _impala_fragments(card: str) -> dict:
    """(d) IMPALA's update_from_fragments, one [50, 8] Nature-CNN fragment
    (400 rows) an update, FRAG_UPDATES updates from the same weights on
    the card and on the CPU, held by ``_hold_updates``; then timed."""
    from ray_tpu_torch.rllib.algorithms.impala import IMPALALearner

    frags = [_cnn_fragment(100 + i) for i in range(FRAG_UPDATES)]
    res = _hold_cnn("[tune+rllib] (d) IMPALA update_from_fragments, Nature-CNN, fragments "
                    "[50, 8],", card, IMPALALearner, IMPALA_CONF, "fragment_loss",
                    lambda lrn: [lrn.update_from_fragments([f]) for f in frags], 1e-4)
    learner = res.pop("learners")["cuda"]
    res["update_ms_all"] = _time_card(lambda: learner.update_from_fragments([frags[0]]))
    res["update_ms"] = statistics.median(res["update_ms_all"])
    print(f"[tune+rllib] (d) IMPALA's update of one [50, 8] fragment on the card: "
          f"{res['update_ms']:.2f} ms (runs {[round(x, 2) for x in res['update_ms_all']]}; the "
          f"held {FRAG_UPDATES} on the three learners took {res['held_s']:.2f} s with the "
          f"card's warm-up); metrics {res['metrics_cuda']} — {card}",
          flush=True)
    return res


def _appo_updates(card: str) -> dict:
    """(e) APPO's own loss (the clipped surrogate against its target
    policy) through update_from_batch, as its learner thread takes each
    runner batch: APPO_UPDATES fragments flattened env by env, held by
    ``_hold_updates``; the target re-synced after every second update
    (checked on the card's learner); then timed.  The streaming path's
    APPO update is IMPALA's fragment loss, as in the reference, which (d)
    holds."""
    from ray_tpu_torch.rllib import SampleBatch
    from ray_tpu_torch.rllib.algorithms.appo import APPOLearner

    batches = [_env_major(_cnn_fragment(200 + i)) for i in range(APPO_UPDATES)]
    synced = {}  # id(learner) -> after each update, whether its target equals its weights

    def run(learner):
        out = []
        for b in batches:
            out.append(learner.update_from_batch(SampleBatch(b)))
            synced.setdefault(id(learner), []).append(all(
                torch.equal(learner.old_params[n], p.detach())
                for n, p in learner.module.named_parameters()))
        return out

    res = _hold_cnn("[tune+rllib] (e) APPO update_from_batch, Nature-CNN, 400 rows a batch,",
                    card, APPOLearner, APPO_CONF, "compute_loss", run, 1e-4)
    learner = res.pop("learners")["cuda"]
    synced = res["target_synced_after_update"] = synced[id(learner)]
    want = [(i + 1) % APPO_CONF["target_network_update_freq"] == 0 for i in range(APPO_UPDATES)]
    res["update_ms_all"] = _time_card(lambda: learner.update_from_batch(SampleBatch(batches[0])))
    res["update_ms"] = statistics.median(res["update_ms_all"])
    print(f"[tune+rllib] (e) APPO's update of 400 rows on the card: {res['update_ms']:.2f} ms "
          f"(runs {[round(x, 2) for x in res['update_ms_all']]}, the target policy's logp "
          f"included); target synced after updates {synced} (want {want}) — {card}", flush=True)
    if synced != want:
        raise AssertionError(f"(e) APPO's target syncs {synced} != {want}")
    return res


def _ppo_fragments(card: str) -> dict:
    """(f) PPO's fragment path: prepare_fragments (GAE over the merged
    time-major columns, masked standardisation) on the card against the
    CPU, advantages and value targets to 1e-5 of their largest; then
    update_from_fragments of PPO_K fragments (minibatch PPO_MB, PPO_EPOCHS
    epochs) held by ``_hold_updates`` (the learners' generators draw the
    same permutations), then timed."""
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
    from ray_tpu_torch.rllib.core.learner import Learner

    frags = [_cnn_fragment(300 + i) for i in range(PPO_K)]
    prepared = {}
    for dev in ("cuda", "cpu"):
        learner = PPOLearner(_cnn_spec(), {**PPO_FRAG_CONF, "device": dev})
        cols = {k: Learner._merge_time_major(torch.as_tensor(np.stack(
            [f["cols"][k] for f in frags])).to(dev)) for k in ("vf_preds", "rewards",
                                                             "terminateds", "truncateds",
                                                             "loss_mask", "obs", "actions",
                                                             "action_logp")}
        last = torch.as_tensor(np.concatenate([f["last_values"] for f in frags])).to(dev)
        with torch.no_grad():
            out = learner.prepare_fragments(cols, last)
        prepared[dev] = {k: out[k].cpu() for k in ("advantages", "value_targets")}
    gae_err = {k: float((prepared["cuda"][k] - v).abs().max() / v.abs().max())
               for k, v in prepared["cpu"].items()}
    print(f"[tune+rllib] (f) PPO prepare_fragments of {PPO_K} fragments [50, 8], card vs CPU: "
          f"max error over max {gae_err} (tol 1e-5) — {card}", flush=True)
    if max(gae_err.values()) > 1e-5:
        raise AssertionError(f"(f) prepare_fragments on the card disagrees: {gae_err}")
    res = _hold_cnn(f"[tune+rllib] (f) PPO update_from_fragments, Nature-CNN, {PPO_K} fragments "
                    f"[50, 8], minibatch {PPO_MB}, {PPO_EPOCHS} epochs,", card, PPOLearner,
                    PPO_FRAG_CONF, "compute_loss",
                    lambda lrn: [lrn.update_from_fragments(frags, PPO_MB, PPO_EPOCHS)],
                    CNN_LOSS_TOL)
    learner = res.pop("learners")["cuda"]
    res["gae_err_over_max"] = gae_err
    res["update_ms_all"] = _time_card(
        lambda: learner.update_from_fragments(frags, PPO_MB, PPO_EPOCHS), reps=3)
    res["update_ms"] = statistics.median(res["update_ms_all"])
    print(f"[tune+rllib] (f) PPO's update of {PPO_K} fragments ({PPO_K * FRAG_T * FRAG_N} rows, "
          f"{res['adam_steps']['module']} Adam steps) on the card: {res['update_ms']:.2f} ms (runs "
          f"{[round(x, 2) for x in res['update_ms_all']]}) — {card}", flush=True)
    return res


def _sebulba_frames(seed: int):
    return np.random.default_rng(seed).integers(0, 256, size=(SEBULBA_B,) + CNN_FRAME,
                                                dtype=np.uint8)


@ray_tpu_torch.remote(num_cpus=0.5)
class SebulbaCaller:
    """A CPU actor standing in for an env runner: SEBULBA_CALLS concurrent
    greedy compute_actions calls of [SEBULBA_B, 84, 84, 4] uint8 frames."""

    def run(self, server, seeds):
        frames = [_sebulba_frames(s) for s in seeds]
        t = time.perf_counter()
        answers = ray_tpu_torch.get([server.compute_actions.remote(f, False) for f in frames],
                                    timeout=120)
        return {"pid": os.getpid(), "wall_s": time.perf_counter() - t, "answers": answers}


def _start_sebulba_server() -> dict:
    """(g)'s InferenceServer actor, created at once: its process imports
    torch and makes its CUDA context while the cluster's other work runs."""
    from ray_tpu_torch.rllib import InferenceServer

    return {"handle": ray_tpu_torch.remote(num_cpus=1)(InferenceServer).remote(
        _cnn_spec(), 0, "cuda"), "created": time.perf_counter()}


def _sebulba_server(card: str, started: dict) -> dict:
    """(g) The sebulba InferenceServer (``_start_sebulba_server``) as a
    runtime actor with its module on the card (one CPU leased, no GPU:
    the lease _setup_podracer gives it), weights set at generation
    SEBULBA_GEN from the driver's CPU
    module, whose pi head is scaled by 100 so that no tie between the top
    two logits decides an action (the smallest gap is printed and must
    reach 1e-3).  SEBULBA_CALLERS CPU actors each send SEBULBA_CALLS
    concurrent greedy calls: every answer carries the generation, the
    actions equal the driver's CPU module's greedy actions, the values
    match to 1e-4 of their largest; the server's process maps libcuda and
    the callers' do not."""
    module = _cnn_spec().build(torch.Generator().manual_seed(7))
    with torch.no_grad():
        module.pi_head.weight.mul_(100.0)
    server, t0 = started["handle"], time.perf_counter()
    ray_tpu_torch.get(server.set_weights.remote(module.get_weights(), SEBULBA_GEN), timeout=120)
    start_s = time.perf_counter() - t0
    ready_s = time.perf_counter() - started["created"]
    callers = [SebulbaCaller.remote() for _ in range(SEBULBA_CALLERS)]
    rounds, results = {}, []
    for name in ("cold", "warm"):  # the first holds the server's first forwards on the card
        seeds = [[1000 * c + i + (500 if name == "warm" else 0) for i in range(SEBULBA_CALLS)]
                 for c in range(SEBULBA_CALLERS)]
        t = time.perf_counter()
        out = ray_tpu_torch.get([c.run.remote(server, sd) for c, sd in zip(callers, seeds)],
                                timeout=300)
        rounds[name] = {"wall_s": time.perf_counter() - t,
                        "caller_ms_per_call": [r["wall_s"] / SEBULBA_CALLS * 1e3 for r in out]}
        results += [(sd, r) for sd, r in zip(seeds, out)]
    server_pid = ray_tpu_torch.get(server.__ray_call__.remote(lambda s: os.getpid()), timeout=60)
    maps = {"server": _maps_libcuda(server_pid),
            "callers": sorted({r["pid"]: _maps_libcuda(r["pid"]) for _, r in results}.items())}
    gens, mismatched, value_err, gap = set(), 0, 0.0, float("inf")
    with torch.no_grad():
        for sd, r in results:
            for s, (acts, _logp, values, gen) in zip(sd, r["answers"]):
                logits, want_v = module(_sebulba_frames(s))
                top2 = logits.topk(2, dim=-1).values
                gap = min(gap, float((top2[:, 0] - top2[:, 1]).min()))
                gens.add(gen)
                mismatched += int((acts != logits.argmax(-1).numpy()).sum())
                value_err = max(value_err, float(np.abs(values - want_v.numpy()).max()
                                                 / want_v.abs().max()))
    for c in callers:
        ray_tpu_torch.kill(c)
    ray_tpu_torch.kill(server)
    n_calls = SEBULBA_CALLERS * SEBULBA_CALLS
    for r in rounds.values():
        r["ms_per_call"] = r["wall_s"] / n_calls * 1e3
    res = {"server_wait_s": start_s, "server_ready_s": ready_s, "rounds": rounds,
           "calls_a_round": n_calls,
           "generations": sorted(gens), "mismatched_actions": mismatched,
           "value_err_over_max": value_err, "min_top2_gap": gap, "maps_libcuda": maps}
    timing = "; ".join(
        f"{name} round {r['wall_s']:.2f} s, {r['ms_per_call']:.2f} ms a call over all (each "
        f"caller's {[round(x, 2) for x in r['caller_ms_per_call']]})" for name, r in rounds.items())
    print(f"[tune+rllib] (g) sebulba InferenceServer on the card (num_cpus=1, no GPU lease; "
          f"created at the phase's start, set at generation {SEBULBA_GEN} {ready_s:.1f} s after "
          f"its creation, {start_s:.2f} s of it waited here): "
          f"{SEBULBA_CALLERS} CPU actors x {SEBULBA_CALLS} concurrent greedy calls of "
          f"[{SEBULBA_B}, 84, 84, 4] uint8, two rounds: {timing}; generations {sorted(gens)}, "
          f"actions != the driver's CPU greedy {mismatched} of {2 * n_calls * SEBULBA_B} "
          f"(smallest top-two gap {gap:.3e}), values {value_err:.2e} of max (tol 1e-4); "
          f"libcuda mapped: server {maps['server']}, callers {maps['callers']} — {card}",
          flush=True)
    if not (gens == {SEBULBA_GEN} and mismatched == 0 and value_err <= 1e-4 and gap >= 1e-3
            and maps["server"] and not any(m for _, m in maps["callers"])):
        raise AssertionError(f"(g) the sebulba server's answers: {res}")
    return res


def _podracer_loop(card: str) -> dict:
    """(h) IMPALA with .podracer() on CartPole-v1 at
    tests/test_rllib_podracer.py's configuration, its learner on the
    card: the runners stream over ring channels, the generation
    advances, fragments arrive, the loss is finite; env-steps/s."""
    from ray_tpu_torch.rllib import IMPALAConfig

    c = PODRACER_LOOP
    cfg = (IMPALAConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=c["num_env_runners"],
                        num_envs_per_env_runner=c["num_envs_per_env_runner"])
           .podracer().training(lr=c["lr"], rollout_fragment_length=c["rollout_fragment_length"])
           .learners(device="cuda").debugging(seed=c["seed"]))
    algo = cfg.build()
    try:
        t = time.perf_counter()
        outs = [algo.train() for _ in range(c["iterations"])]
        wall = time.perf_counter() - t
        plane = algo.env_runner_group
        kinds = sorted({rs.traj.kind for rs in plane.streams if rs.alive})
        device = str(algo.learner_group._local.device)
    finally:
        algo.cleanup()
    steps = sum(o["num_env_steps_sampled"] for o in outs)
    res = {"kinds": kinds, "device": device, "generations": [o["weight_generation"] for o in outs],
           "fragments_received": outs[-1]["fragments_received"], "total_loss": outs[-1]["total_loss"],
           "env_steps": steps, "wall_s": wall, "env_steps_per_s": steps / wall}
    print(f"[tune+rllib] (h) IMPALA .podracer() on CartPole-v1 {c}, learner on {device}: "
          f"transports {kinds}, generations {res['generations']}, fragments received "
          f"{res['fragments_received']}, loss {res['total_loss']:.4f}, "
          f"{res['env_steps_per_s']:.0f} env-steps/s ({steps} in {wall:.1f} s) — {card}", flush=True)
    if not (kinds == ["ring"] and device.startswith("cuda") and res["fragments_received"] > 0
            and res["generations"][-1] > res["generations"][0]
            and math.isfinite(res["total_loss"])):
        raise AssertionError(f"(h) the streaming loop: {res}")
    return res


def _part(parts: dict, name: str, fn, *args, tag: str = "tune and rllib"):
    """fn(*args), its seconds kept in ``parts`` and printed as a [timing] line."""
    t = time.perf_counter()
    out = fn(*args)
    parts[name] = time.perf_counter() - t
    print(f"[timing] {tag} {name}: {parts[name]:.1f} s", flush=True)
    return out


def phase_tune_rllib(card: str, raw: dict) -> dict:
    """Tune and RLlib on the card under a cluster of their own: (a) the
    Tune sweep of GPT-2 small's TorchTrainer; (b) PPO on CartPole-v1
    under a Tuner, where gymnasium is installed (its absence is recorded,
    and (b) is not run); (g) the sebulba inference server on the card;
    (h) IMPALA's streaming loop, where gymnasium is installed; then,
    without the cluster, (c) the Nature-CNN learner, (d) IMPALA's, (e)
    APPO's and (f) PPO's fragment updates, card vs CPU.  ``raw`` is phase
    9's result (the direct run)."""
    import importlib.util

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = {"card": card}
    parts = res["seconds_by_part"] = {}
    has_gym = importlib.util.find_spec("gymnasium") is not None
    no_gym = "gymnasium is not installed on this machine"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as storage:
        ray_tpu_torch.init(num_cpus=4)
        parts["init"] = time.perf_counter() - t0
        try:
            server = _start_sebulba_server()  # its start-up overlaps (a)
            res["sweep"] = _tune_sweep(card, raw, storage)
            parts["sweep"] = time.perf_counter() - t0 - sum(parts.values())
            if has_gym:
                res["ppo"] = _ppo_under_tune(card, storage)
                parts["ppo"] = time.perf_counter() - t0 - sum(parts.values())
            else:
                res["ppo"] = {"not_run": no_gym}
                print("[tune+rllib] (b) NOT RUN: gymnasium is not installed on this machine, "
                      "so CartPole-v1 cannot be made; PPO on the card waits for the package "
                      f"(ROADMAP.md Queue A item 5) — {card}", flush=True)
            res["sebulba"] = _part(parts, "(g) sebulba server", _sebulba_server, card, server)
            if has_gym:
                res["podracer_loop"] = _part(parts, "(h) podracer loop", _podracer_loop, card)
            else:
                res["podracer_loop"] = {"not_run": no_gym}
                print("[tune+rllib] (h) NOT RUN: gymnasium is not installed on this machine, "
                      "so CartPole-v1 cannot be made; IMPALA's streaming loop on the card "
                      f"waits for the package (ROADMAP.md Queue A item 5) — {card}", flush=True)
        finally:
            ray_tpu_torch.shutdown()
    res["processes_left"] = _wait_no_port_processes("tune+rllib")
    res["rings_left"] = _ring_dirs()
    if res["rings_left"]:
        raise AssertionError(f"ring directories left after shutdown(): {res['rings_left']}")
    parts["shutdown"] = time.perf_counter() - t0 - sum(parts.values())
    res["cnn"] = _cnn_learner(card)
    parts["cnn"] = time.perf_counter() - t0 - sum(parts.values())
    res["impala"] = _part(parts, "(d) IMPALA fragments", _impala_fragments, card)
    res["appo"] = _part(parts, "(e) APPO updates", _appo_updates, card)
    res["ppo_fragments"] = _part(parts, "(f) PPO fragments", _ppo_fragments, card)
    res["seconds"] = time.perf_counter() - t0
    print(f"[tune+rllib] phase took {res['seconds']:.1f} s: "
          f"{ {k: round(v, 1) for k, v in parts.items()} }", flush=True)
    print("[tune+rllib] " + json.dumps(res), flush=True)
    return res


# ----------------------------------------------------------------------
# Phase 22: the rest of RLlib — DQN, SAC, the offline algorithms (BC,
# MARWIL, CQL, OfflineData, the estimators), multi-agent PPO and DreamerV3,
# each update card vs CPU from the same weights and noise
# ----------------------------------------------------------------------
RL_DQN_UPDATES, RL_DQN_SYNC_AFTER, RL_DQN_B = 8, 4, 32  # DQNConfig's batch
RL_SAC_UPDATES, RL_SAC_B = 4, 256  # SACConfig's train_batch_size
RL_OFFLINE_ROWS, RL_OFFLINE_EP = 1024, 32
RL_DREAMER_TIMED = 8


def _rl_transitions(n: int, obs_dim: int, seed: int, discrete: bool, act_dim: int = 1,
                    act_high: float = 2.0) -> dict:
    """Seeded transitions: obs, actions, rewards, next_obs, terminateds."""
    rng = np.random.default_rng(seed)
    acts = (rng.integers(0, act_dim, n) if discrete
            else rng.uniform(-act_high, act_high, (n, act_dim)).astype(np.float32))
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32), "actions": acts,
            "rewards": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "terminateds": rng.random(n) < 0.05}


def _rl_dqn(card: str) -> dict:
    """(a) DQNLearner at the reference's defaults (hidden (64, 64), dueling
    heads, lr 5e-4) on CartPole's shapes, batch 32: 8 updates from one
    PrioritizedReplayBuffer of seeded transitions, each replay batch fed
    to the card's and the CPU's learners alike, its priorities updated
    from the CPU's TD errors (the card's held to them to 1e-4 of their
    max), the target synced after update 4."""
    from ray_tpu_torch.rllib import PrioritizedReplayBuffer, RLModuleSpec, SampleBatch
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, DQNLearner

    dcfg = DQNConfig()
    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(64, 64))
    conf = {"lr": dcfg.lr, "gamma": dcfg.gamma, "grad_clip": None, "seed": 0}
    buf = PrioritizedReplayBuffer(capacity=4096, seed=0)
    buf.add(SampleBatch(_rl_transitions(2048, 4, 3, discrete=True, act_dim=2)))
    td_err = []

    def run_all(learners):
        out = {k: [] for k in learners}
        for i in range(RL_DQN_UPDATES):
            replay = buf.sample(RL_DQN_B)
            tds = {}
            for key, learner in learners.items():
                out[key].append(learner.update_from_batch(replay))
                tds[key] = learner.last_td_error()
                if i + 1 == RL_DQN_SYNC_AFTER:
                    learner.update_target()
            td_err.append(float(np.abs(tds["cuda"] - tds["cpu"]).max() / np.abs(tds["cpu"]).max()))
            buf.update_priorities(replay["batch_indexes"], tds["cpu"])
        return out

    res = _hold_updates("[rllib rest] (a) DQN", card,
                        lambda d: DQNLearner(spec, {**conf, "device": d}), _learner_optimizers,
                        run_all, {"module": dcfg.lr})
    learners = res.pop("learners")
    card_l, cpu_l = learners["cuda"], learners["cpu"]
    target_err = max(float((card_l.target.state_dict()[k].cpu() - v).abs().max())
                     for k, v in cpu_l.target.state_dict().items())
    replay = buf.sample(RL_DQN_B)
    ms = _time_card(lambda: card_l.update_from_batch(replay))
    res.update(td_rel_err=max(td_err), target_err=target_err, update_ms=statistics.median(ms),
               update_ms_all=ms)
    print(f"[rllib rest] (a) DQN TD errors card vs CPU {max(td_err):.2e} of max (tol 1e-4) over "
          f"{RL_DQN_UPDATES} updates; the target (synced after update {RL_DQN_SYNC_AFTER}) "
          f"{target_err:.2e} from the CPU's; an update of {RL_DQN_B} rows on the card "
          f"{res['update_ms']:.2f} ms (runs {[round(x, 2) for x in ms]}) — {card}", flush=True)
    if max(td_err) > 1e-4 or target_err > 2 * dcfg.lr * RL_DQN_SYNC_AFTER:
        raise AssertionError(f"(a) DQN's TD errors or target disagree: {res}")
    return res


def _sac_conf(cfg, **extra) -> dict:
    return {"lr": cfg.lr, "gamma": cfg.gamma, "tau": cfg.tau, "initial_alpha": cfg.initial_alpha,
            "target_entropy": cfg.target_entropy, "seed": 0, "hidden": (256, 256),
            "action_low": np.array([-2.0], np.float32),
            "action_high": np.array([2.0], np.float32), **extra}


def _sac_optimizers(lrn) -> dict:
    return {"pi": (lrn.pi_opt, _named(lrn.pi_net)), "q": (lrn.q_opt, _named(lrn.q_net)),
            "alpha": (lrn.alpha_opt, [("log_alpha", lrn.log_alpha)])}


def _rl_sac(card: str) -> dict:
    """(b) SACLearner at hidden (256, 256) on Pendulum's shapes (obs 3, one
    action in [-2, 2]), batch 256: 4 updates, each with one draw of noise
    fed to every learner; alpha, the target critics' Polyak step and the
    state's numpy round trip checked on the card."""
    from ray_tpu_torch.rllib import RLModuleSpec, SampleBatch
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig, SACLearner

    scfg = SACConfig()
    spec = RLModuleSpec(observation_dim=3, action_dim=1, discrete=False, hidden=(256, 256))
    conf = _sac_conf(scfg)
    batches = [SampleBatch(_rl_transitions(RL_SAC_B, 3, 10 + i, discrete=False))
               for i in range(RL_SAC_UPDATES)]
    draw = SACLearner(spec, {**conf, "device": "cpu", "seed": 5})
    noises = [draw.draw_noise(RL_SAC_B) for _ in batches]
    polyak = {}

    def run_all(learners):
        out = {}
        for key, learner in learners.items():
            out[key] = []
            for b, nz in zip(batches, noises):
                before = {k: v.detach().clone() for k, v in learner.target_q.state_dict().items()}
                out[key].append(learner.update_from_batch(b, noise=nz))
                # target <- (1 - tau) target + tau q, the step just taken
                q = learner.q_net.state_dict()
                polyak[key] = max([polyak.get(key, 0.0)] + [
                    float((learner.target_q.state_dict()[k] - ((1 - scfg.tau) * v + scfg.tau * q[k]))
                          .abs().max()) for k, v in before.items()])
        return out

    res = _hold_updates("[rllib rest] (b) SAC", card,
                        lambda d: SACLearner(spec, {**conf, "device": d}), _sac_optimizers,
                        run_all, {"pi": scfg.lr, "q": scfg.lr, "alpha": scfg.lr})
    card_l = res.pop("learners")["cuda"]
    alpha = (res["metrics_cuda"]["alpha"], res["metrics_cpu"]["alpha"])
    state = card_l.get_state()
    fresh = SACLearner(spec, {**conf, "device": "cuda", "seed": 9})
    fresh.set_state(state)
    again = fresh.get_state()
    round_trip = all(np.array_equal(again[k][n], v)
                     for k in ("pi", "q", "target_q") for n, v in state[k].items())
    round_trip = round_trip and bool(np.array_equal(again["log_alpha"], state["log_alpha"]))
    ms = _time_card(lambda: card_l.update_from_batch(batches[0], noise=noises[0]))
    res.update(alpha=alpha, polyak_err=polyak["cuda"], state_round_trip=round_trip,
               update_ms=statistics.median(ms), update_ms_all=ms)
    print(f"[rllib rest] (b) SAC alpha after {RL_SAC_UPDATES} updates {alpha[0]:.8f} on the "
          f"card, {alpha[1]:.8f} on the CPU; the target critics' Polyak step {polyak['cuda']:.2e} "
          f"from (1 - tau) target + tau q (tol 1e-6); the state's numpy round trip "
          f"{'exact' if round_trip else 'DIFFERS'}; an update of {RL_SAC_B} rows on the card "
          f"{res['update_ms']:.2f} ms (runs {[round(x, 2) for x in ms]}) — {card}", flush=True)
    if not (round_trip and polyak["cuda"] <= 1e-6 and _rel_err(*alpha) <= 1e-4):
        raise AssertionError(f"(b) SAC's alpha, target or state disagrees: {res}")
    return res


def _rl_offline_rows() -> list:
    """Seeded transitions on Pendulum's shapes in episodes of
    RL_OFFLINE_EP rows, with a behaviour logp, as JSON-able rows."""
    rng = np.random.default_rng(21)
    n = RL_OFFLINE_ROWS
    obs = rng.standard_normal((n, 3)).astype(np.float32)
    acts = np.clip(0.5 * obs[:, :1] + 0.3 * rng.standard_normal((n, 1)), -2, 2).astype(np.float32)
    ends = (np.arange(n) % RL_OFFLINE_EP) == RL_OFFLINE_EP - 1
    return [{"obs": obs[i].tolist(), "actions": acts[i].tolist(),
             "rewards": float(-np.sum((acts[i] - 0.5 * obs[i, :1]) ** 2)),
             "terminateds": bool(ends[i]), "truncateds": False,
             "eps_id": int(i // RL_OFFLINE_EP), "action_logp": float(-0.3 - 0.1 * (i % 7))}
            for i in range(n)]


def _rl_offline_write_read(root: str) -> dict:
    """(c), inside the cluster: the rows written as parquet through the
    port's Data and as JSONL through JsonWriter, each read back through
    OfflineData; every column equal to the written rows, in order."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.rllib import SampleBatch
    from ray_tpu_torch.rllib.offline import JsonWriter, OfflineData

    rows = _rl_offline_rows()
    written = SampleBatch({k: np.asarray([r[k] for r in rows]) for k in rows[0]})
    rd.from_items(rows, parallelism=1).write_parquet(os.path.join(root, "parquet"))
    w = JsonWriter(os.path.join(root, "jsonl"), max_rows_per_shard=RL_OFFLINE_ROWS // 4)
    w.write(written)
    w.close()
    out = {}
    for fmt in ("parquet", "jsonl"):
        ds = OfflineData(os.path.join(root, fmt))
        same = ds.count == len(rows) and all(
            np.array_equal(np.asarray(ds[k], written[k].dtype).reshape(written[k].shape), written[k])
            for k in written)
        out[fmt] = {"rows": ds.count, "equal": bool(same)}
        if not same:
            raise AssertionError(f"(c) OfflineData from {fmt} differs from the written rows")
    print(f"[rllib rest] (c) {len(rows)} transitions written as parquet (port's Data) and JSONL "
          f"(JsonWriter, 4 shards), read back through OfflineData: {out}", flush=True)
    out["data"] = OfflineData(os.path.join(root, "parquet"))
    return out


def _rl_offline(card: str, io: dict) -> dict:
    """(c) on the data ``io`` read back: BC and MARWIL each one train()
    iteration with the learner on cuda, held by ``_hold_updates`` against
    the same on the CPU (every Adam step's loss, the first step, the
    weights after it); CQL's
    learner (hidden (256, 256), batch 256, bc_iters 1) one update in its
    BC phase and one after it with injected noise; IS and WIS of one
    RLModule's weights on the card and on the CPU."""
    from ray_tpu_torch.rllib import BCConfig, MARWILConfig, RLModuleSpec, SampleBatch
    from ray_tpu_torch.rllib.algorithms.cql import CQLConfig, CQLLearner
    from ray_tpu_torch.rllib.offline import ImportanceSampling, WeightedImportanceSampling

    data = io.pop("data")
    res = {"read": io}
    held = ("bc_logp", "logp", "entropy", "mean_adv_weight")
    for name, cfg_cls, extra in (("BC", BCConfig, {}), ("MARWIL", MARWILConfig, {"beta": 1.0})):
        def build(dev, cfg_cls=cfg_cls, extra=extra):
            return (cfg_cls().offline_data(input_=data)
                    .training(train_batch_size=512, minibatch_size=128, num_epochs=2,
                              model={"hidden": (256, 256)}, **extra)
                    .learners(device=dev).debugging(seed=3)).build()

        def train(algo):
            # the learner's metrics (of the last minibatch), not train()'s counters
            return [{k: v for k, v in algo.train().items() if k.endswith("loss") or k in held}]

        out = _hold_updates(
            f"[rllib rest] (c) {name} train(), 512 rows x 2 epochs of minibatch 128, hidden "
            f"(256, 256),", card, build,
            lambda algo: _learner_optimizers(algo.learner_group._local), _each(train),
            {"module": cfg_cls().lr}, lambda metric: CNN_LOSS_TOL,
            loss_of=lambda algo: (algo.learner_group._local, "compute_loss"))
        algos = out.pop("learners")
        for algo in algos.values():
            algo.cleanup()
        out["device"] = str(algos["cuda"].learner_group._local.device)
        res[name] = out
        if not out["device"].startswith("cuda"):
            raise AssertionError(f"(c) {name}'s learner is not on the card: {out}")

    data.ensure_next_obs()
    ccfg = CQLConfig()
    spec = RLModuleSpec(observation_dim=3, action_dim=1, discrete=False, hidden=(256, 256))
    conf = _sac_conf(ccfg, bc_iters=1, temperature=ccfg.temperature,
                     num_actions=ccfg.num_actions, min_q_weight=ccfg.min_q_weight)
    batches = [data.sample(RL_SAC_B) for _ in range(2)]
    draw = CQLLearner(spec, {**conf, "device": "cpu", "seed": 5})
    noises = [draw.draw_noise(RL_SAC_B) for _ in batches]

    def run_all(learners):
        return {key: [lrn.update_from_batch(b, noise=nz) for b, nz in zip(batches, noises)]
                for key, lrn in learners.items()}

    cql = _hold_updates("[rllib rest] (c) CQL", card,
                        lambda d: CQLLearner(spec, {**conf, "device": d}), _sac_optimizers,
                        run_all, {"pi": ccfg.lr, "q": ccfg.lr, "alpha": ccfg.lr})
    card_l = cql.pop("learners")["cuda"]
    ms = _time_card(lambda: card_l.update_from_batch(batches[1], noise=noises[1]))
    cql.update(update_ms=statistics.median(ms), update_ms_all=ms)
    res["CQL"] = cql
    print(f"[rllib rest] (c) CQL updates 1 (BC phase) and 2 (SAC's actor) held; an update of "
          f"{RL_SAC_B} rows on the card {cql['update_ms']:.2f} ms (runs "
          f"{[round(x, 2) for x in ms]}) — {card}", flush=True)

    module = RLModuleSpec(observation_dim=3, action_dim=1, discrete=False,
                          hidden=(64, 64)).build(torch.Generator().manual_seed(4))
    on_card = copy.deepcopy(module).to("cuda")
    # a behaviour logp near the module's own, so the episodes' weights
    # neither vanish nor hit the estimators' clip
    with torch.no_grad():
        logp = module.forward_train(torch.as_tensor(np.asarray(data["obs"], np.float32)),
                                    torch.as_tensor(np.asarray(data["actions"], np.float32)))[0]
    noise = 0.05 * np.random.default_rng(8).standard_normal(data.count)
    episodes = SampleBatch({**data.batch, "action_logp": (logp.numpy() + noise).astype(np.float32)})
    est = {}
    for cls in (ImportanceSampling, WeightedImportanceSampling):
        want = cls(module, gamma=0.99).estimate(episodes)
        t = time.perf_counter()
        got = cls(on_card, gamma=0.99).estimate(episodes)
        est[cls.__name__] = {"card": got, "cpu": want, "card_s": time.perf_counter() - t,
                             "rel_err": max(_rel_err(got[k], v, 1e-6) for k, v in want.items())}
    res["estimators"] = est
    errs = {k: f"{v['rel_err']:.1e}" for k, v in est.items()}
    print(f"[rllib rest] (c) IS and WIS over {RL_OFFLINE_ROWS // RL_OFFLINE_EP} episodes, the "
          f"target logp from the module on the card vs the CPU: {errs} (tol 1e-5); v_target "
          f"{ {k: round(v['card']['v_target'], 6) for k, v in est.items()} } — {card}", flush=True)
    if any(v["rel_err"] > 1e-5 for v in est.values()):
        raise AssertionError(f"(c) the estimates on the card disagree: {est}")
    return res


class _SmokeWalkers:
    """A two-agent env in plain Python (no gymnasium): each agent moves -1
    or +1 a step on a line and is rewarded for staying near 0; walker_1
    leaves the episode past 3, the episode truncates after 16 steps."""

    possible_agents = ["walker_0", "walker_1"]

    def __init__(self):
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = {a: float(self._rng.integers(-2, 3)) for a in self.possible_agents}
        self._t = 0
        return {a: self._obs(a) for a in self._pos}, {}

    def _obs(self, agent):
        return np.array([self._pos[agent] / 4.0, self._t / 16.0, float(agent[-1] == "1")],
                        np.float32)

    def step(self, action_dict):
        self._t += 1
        obs, rew, term, trunc = {}, {}, {}, {}
        for a, act in action_dict.items():
            self._pos[a] += 1.0 if int(act) == 1 else -1.0
            rew[a] = 1.0 - abs(self._pos[a]) / 4.0
            term[a] = a == "walker_1" and abs(self._pos[a]) > 3
            trunc[a] = self._t >= 16
            if term[a]:
                del self._pos[a]
            else:
                obs[a] = self._obs(a)
        term["__all__"] = not self._pos
        trunc["__all__"] = self._t >= 16
        return obs, rew, term, trunc, {}

    def close(self):
        pass


def _rl_multi_agent(card: str, root: str) -> dict:
    """(d), inside the cluster: PPO with multi_agent() of two explicit
    RLModuleSpecs on _SmokeWalkers, two CPU env runner actors, a learner
    group a policy on cuda: one train() iteration reports both policies;
    the learners on the card, the runners without a CUDA context; a
    checkpoint restores both policies' weights (float64 sums)."""
    from ray_tpu_torch.rllib import PPOConfig, RLModuleSpec

    specs = {p: RLModuleSpec(observation_dim=3, action_dim=2, hidden=(64, 64))
             for p in ("p0", "p1")}
    cfg = (PPOConfig().environment(env_creator=_SmokeWalkers)
           .env_runners(num_env_runners=2, num_cpus_per_env_runner=0.5, rollout_fragment_length=64)
           .multi_agent(policies=specs, policy_mapping_fn=lambda agent: "p" + agent[-1])
           .training(train_batch_size=256, minibatch_size=64, num_epochs=2)
           .learners(device="cuda").debugging(seed=1))
    t = time.perf_counter()
    algo = cfg.build()
    res = {"build_s": time.perf_counter() - t}
    ckpt = os.path.join(root, "ma_ckpt")
    try:
        t = time.perf_counter()
        out = algo.train()
        res["train_s"] = time.perf_counter() - t
        states = ray_tpu_torch.get([r.__ray_call__.remote(_cuda_state)
                                    for r in algo.env_runner_group.runners])
        res.update(policies=sorted(k for k in out if k in specs),
                   env_steps=out["num_env_steps_sampled"],
                   losses={p: out[p]["total_loss"] for p in specs},
                   learner_devices={p: str(lg._local.device)
                                    for p, lg in algo.learner_groups.items()},
                   runners_cuda_context=[ctx for _, ctx in states],
                   runners_map_uvm=[_maps_uvm(pid) for pid, _ in states],
                   driver_maps_uvm=_maps_uvm(os.getpid()),
                   runners_map_libcuda=[_maps_libcuda(pid) for pid, _ in states])
        res["weights_sum"] = {p: _weights_sum(w) for p, w in algo.get_policy_weights().items()}
        os.makedirs(ckpt)
        algo.save_checkpoint(ckpt)
    finally:
        algo.cleanup()
    # restored into a build whose runner is local (no actor to start)
    t = time.perf_counter()
    restored = cfg.copy().env_runners(num_env_runners=0).build()
    try:
        restored.load_checkpoint(ckpt)
        res["restored_sum"] = {p: _weights_sum(w) for p, w in restored.get_policy_weights().items()}
        res["restore_s"] = time.perf_counter() - t
    finally:
        restored.cleanup()
    print(f"[rllib rest] (d) multi-agent PPO on _SmokeWalkers (no gymnasium), 2 CPU runner "
          f"actors, learner groups {res['learner_devices']}: one train() "
          f"({res['train_s']:.2f} s; build {res['build_s']:.2f} s) reports {res['policies']} over "
          f"{res['env_steps']} agent steps, losses {res['losses']}; a CUDA context in the "
          f"runners {res['runners_cuda_context']}, /dev/nvidia-uvm mapped in the runners "
          f"{res['runners_map_uvm']} and in the driver {res['driver_maps_uvm']} (libcuda mapped "
          f"{res['runners_map_libcuda']}: import torch maps it); checkpoint weight sums {res['weights_sum']} restored "
          f"as {res['restored_sum']} ({res['restore_s']:.2f} s) — {card}", flush=True)
    if not (res["policies"] == ["p0", "p1"] and res["restored_sum"] == res["weights_sum"]
            and all(d.startswith("cuda") for d in res["learner_devices"].values())
            and not any(res["runners_cuda_context"]) and not any(res["runners_map_uvm"])
            and res["driver_maps_uvm"]
            and all(math.isfinite(v) for v in res["losses"].values())):
        raise AssertionError(f"(d) multi-agent PPO on the card failed its checks: {res}")
    return res


def _dreamer_batch(cfg, obs_dim: int, n_act: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    B, L = cfg.batch_seqs, cfg.seq_len
    is_first = (rng.random((B, L)) < 0.05).astype(np.float32)
    is_first[:, 0] = 1.0
    return {"obs": rng.standard_normal((B, L, obs_dim)).astype(np.float32),
            "prev_actions": np.eye(n_act, dtype=np.float32)[rng.integers(0, n_act, (B, L))],
            "rewards": np.ones((B, L), np.float32),
            "terminateds": (rng.random((B, L)) < 0.05).astype(np.float32),
            "is_first": is_first}


def _rl_dreamer(card: str) -> dict:
    """(e) DreamerV3Learner at the reference's defaults (deter 128, 8 x 8
    stochastic, hidden (128,), 16 sequences of 16 steps, horizon 10) on
    CartPole's shapes: one update with injected Gumbel noise, card vs CPU
    (each world-model loss term to 1e-4 relative, each gradient of the
    three AdamWs to 1e-3 of max, the parameters after them by phase 8's
    rule); then 8 updates timed on the card."""
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3Config, DreamerV3Learner

    obs_dim, n_act = 4, 2
    cfg = DreamerV3Config()
    batch = _dreamer_batch(cfg, obs_dim, n_act, 31)
    draw = DreamerV3Learner(copy.deepcopy(cfg).learners(device="cpu"), obs_dim, n_act, seed=5)
    noise = draw.draw_noise(cfg.batch_seqs, cfg.seq_len)

    def run_all(learners):
        return {key: [lrn.update_from_batch(batch, noise=noise)] for key, lrn in learners.items()}

    def first_tol(metric):
        # the world model's terms come from identical weights; the actor's
        # and critic's read the world model after its AdamW step
        return 1e-4 if metric.startswith("wm_") or metric == "world_model_loss" else CNN_LOSS_TOL

    res = _hold_updates(
        "[rllib rest] (e) DreamerV3", card,
        lambda d: DreamerV3Learner(copy.deepcopy(cfg).learners(device=d), obs_dim, n_act, seed=0),
        lambda lrn: {"wm": (lrn.wm_opt, _named(lrn.nets)),
                     "actor": (lrn.actor_opt, _named(lrn.actor)),
                     "critic": (lrn.critic_opt, _named(lrn.critic))},
        run_all, {"wm": cfg.lr, "actor": cfg.actor_lr, "critic": cfg.critic_lr},
        first_tol=first_tol)
    card_l = res.pop("learners")["cuda"]
    ms = _time_card(lambda: card_l.update_from_batch(batch), reps=RL_DREAMER_TIMED)
    res.update(update_ms=statistics.median(ms), update_ms_all=ms)
    print(f"[rllib rest] (e) DreamerV3 update ([16, 16] sequences, horizon 10) on the card "
          f"{res['update_ms']:.2f} ms (median of {RL_DREAMER_TIMED}: "
          f"{[round(x, 2) for x in ms]}); metrics {res['metrics_cuda']} — {card}", flush=True)
    return res


def phase_rllib_rest(card: str) -> dict:
    """The rest of RLlib on the card, f32, card vs CPU from the same
    weights and noise: under a cluster of its own, (c)'s parquet and JSONL
    round trips and (d) multi-agent PPO; then (a) DQN, (b) SAC, (c) BC,
    MARWIL, CQL and the estimators, (e) DreamerV3."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = {"card": card}
    parts = res["seconds_by_part"] = {}

    def part(name, fn, *args):
        return _part(parts, name, fn, *args, tag="rllib rest")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rllib_") as root:
        ray_tpu_torch.init(num_cpus=4)
        try:
            io = part("(c) offline write and read", _rl_offline_write_read, root)
            res["multi_agent"] = part("(d) multi-agent PPO", _rl_multi_agent, card, root)
        finally:
            ray_tpu_torch.shutdown()
        res["processes_left"] = _wait_no_port_processes("rllib rest")
        parts["shutdown"] = time.perf_counter() - t0 - sum(parts.values())
    res["dqn"] = part("(a) DQN", _rl_dqn, card)
    res["sac"] = part("(b) SAC", _rl_sac, card)
    res["offline"] = part("(c) offline", _rl_offline, card, io)
    res["dreamer"] = part("(e) DreamerV3", _rl_dreamer, card)
    res["seconds"] = time.perf_counter() - t0
    print(f"[rllib rest] phase took {res['seconds']:.1f} s: "
          f"{ {k: round(v, 1) for k, v in parts.items()} }", flush=True)
    print("[rllib rest] " + json.dumps(res, default=str), flush=True)
    return res


# ----------------------------------------------------------------------
# Phase 23: the operator's surface.  A head started by the CLI serves the
# dashboard; an autoscaler beside it brings up the GPU node that a submitted
# job's workflow step asks for, and drains it when the job is done.
# ----------------------------------------------------------------------
OPERATOR_IDLE_S = 2.0  # the autoscaler's idle timeout for the GPU node
OPERATOR_DRAIN_S = 5.0  # idle_drain_deadline_s: the notice an idle node's drain gets
OPERATOR_MARK = "CHIP_SMOKE_JOB_MARK"  # the variable the job's runtime_env sets
OPERATOR_NODE_TYPES = {"gpu_worker": {"resources": {"CPU": 2, "GPU": 1}}}
OPERATOR_WORKFLOW = "gpt2_last_logits"
# The job's driver: it imports the port and numpy and never torch.  The
# workflow's first step asks for the GPU that only the autoscaled node has,
# and runs phase 15 (c)'s batch 0 through GPT-2 small f32 on the card; the
# second takes the argmax on the head's CPU.
_JOB_SCRIPT = r"""
import json, os, sys, time

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode

storage, out_dir, wf_id, mark = sys.argv[1:5]
B, T, SEED, VOCAB, ROWS = (int(x) for x in sys.argv[5:10])
t0 = time.perf_counter()
ray_tpu_torch.init()  # the job supervisor's address, and the job's runtime_env
workflow.init(storage)


@ray_tpu_torch.remote(num_gpus=1)
def gpt2_last_logits(tokens, seed):
    t_start = time.perf_counter()
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2.GPT2Config.small(dtype=torch.float32, remat=False)
    model = gpt2.init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
    model = model.to("cuda").eval()
    before = fa.flash_attention_fwd.launches
    with torch.inference_mode():
        logits = model(torch.from_numpy(tokens).to("cuda"))[:, -1].cpu().numpy()
    return {"logits": logits, "launches": fa.flash_attention_fwd.launches - before,
            "n_layer": cfg.n_layer, "mark": os.environ.get(mark), "step_pid": os.getpid(),
            "step_node": ray_tpu_torch.get_runtime_context().get_node_id(),
            "step_device": torch.cuda.get_device_name(0), "step_s": time.perf_counter() - t_start}


@ray_tpu_torch.remote
def argmax(out):
    return {**out, "ids": out["logits"].argmax(-1), "argmax_pid": os.getpid(),
            "argmax_torch": "torch" in sys.modules,
            "argmax_node": ray_tpu_torch.get_runtime_context().get_node_id()}


tokens = np.random.default_rng(ROWS).integers(0, VOCAB, size=(B, T))
with InputNode() as inp:
    dag = argmax.bind(gpt2_last_logits.bind(inp, SEED))
out = workflow.run(dag, workflow_id=wf_id, input_val=tokens)
t_run = time.perf_counter()
again = workflow.resume(wf_id)
# stay connected until the GPU step's task event is in the GCS: a job's
# workers go with its driver, and an event still in a worker's buffer
# (flushed each second) goes with them
from ray_tpu_torch.util import state

deadline = time.monotonic() + 30
while not [t for t in state.list_tasks() if t["name"].endswith(".gpt2_last_logits")]:
    if time.monotonic() > deadline:
        break
    time.sleep(0.1)
with open("/proc/self/maps") as f:
    maps = f.read()
np.savez(os.path.join(out_dir, "job.npz"), logits=out["logits"], ids=out["ids"],
         resumed_logits=again["logits"], resumed_ids=again["ids"])
summary = {k: v for k, v in out.items() if k not in ("logits", "ids")}
summary.update(workflow_status=workflow.get_status(wf_id), libtorch="libtorch" in maps,
               libcuda="libcuda" in maps, torch_imported="torch" in sys.modules,
               pid=os.getpid(), workflow_s=t_run - t0)
print("JOB_RESULT " + json.dumps(summary), flush=True)
ray_tpu_torch.shutdown()
"""


def _http_json(url: str) -> object:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _cli(args: list, env: dict, cwd: str) -> str:
    """``python -m ray_tpu_torch.scripts.cli <args>``; its output, or raise."""
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
                          env=env, cwd=cwd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)} failed ({proc.returncode}): "
                             f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    return proc.stdout


def _status_total(out: str, name: str) -> float:
    """A resource's total from ``cli status``'s lines (``  GPU: 0/1 available``);
    a resource the cluster does not have is 0."""
    for line in out.splitlines():
        head, _, rest = line.strip().partition(": ")
        if head == name and rest.endswith(" available"):
            return float(rest.split("/")[1].split()[0])
    return 0.0


def _await(what: str, fn, timeout_s: float, period_s: float = 0.05):
    """fn() until it returns something truthy; raise after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while True:
        out = fn()
        if out:
            return out
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 23: {what} within {timeout_s} s")
        time.sleep(period_s)


def phase_operator(card: str, runtime: dict, inside=None) -> dict:
    """(23) The operator's path: ``cli start --head`` with no GPU, the
    dashboard's API, a FakeMultiNodeProvider autoscaler in this process, a
    job submitted over HTTP whose workflow's GPU step makes the autoscaler
    launch one gpu_worker node and runs GPT-2 small f32 there; the step's
    logits held to phase 15 (c)'s forward of the same batch bit for bit,
    its B1 launches, the job's runtime_env, a resume that runs nothing
    again; then the node's drain and termination, and ``cli stop``.
    ``inside(gcs, session_dir)``, when given, runs in the same head after
    those checks and before ``cli stop`` (phase 25); its result is
    ``res["slice"]``."""
    from ray_tpu_torch._private.worker import get_global_worker
    from ray_tpu_torch.autoscaler import FakeMultiNodeProvider, Monitor, StandardAutoscaler
    from ray_tpu_torch.dashboard import JobSubmissionClient
    from ray_tpu_torch.util import state

    t0 = time.perf_counter()
    want_logits, want_ids = runtime["client_batch0"]
    repo = os.path.dirname(os.path.abspath(__file__))
    marks = {}

    class TimedProvider(FakeMultiNodeProvider):
        """The fake provider, with the times of its launches and terminations."""

        def create_node(self, node_config, tags, count):
            t = time.perf_counter()
            out = super().create_node(node_config, tags, count)
            marks.setdefault("launches", []).append((t, time.perf_counter(), dict(tags), count))
            return out

        def terminate_node(self, node_id):
            marks.setdefault("terminations", []).append((node_id, time.perf_counter()))
            super().terminate_node(node_id)

    # the CLI's head, this process's autoscaler and the fake node it starts
    # take the same settings: no arena prefault, a drain notice that fits the phase
    settings = {"RAY_TPU_TORCH_arena_prefault_bytes": "0",
                "RAY_TPU_TORCH_idle_drain_deadline_s": str(OPERATOR_DRAIN_S)}
    saved = {k: os.environ.get(k) for k in settings}
    res = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_op_") as tmp:
        env = {k: v for k, v in os.environ.items() if not k.startswith("RAY_TPU_TORCH_")}
        env.update(settings, PYTHONPATH=repo, TMPDIR=tmp)
        out = _cli(["start", "--head", "--num-cpus", "4", "--num-gpus", "0"], env, tmp)
        gcs = out.split("started head: gcs=", 1)[1].split()[0]
        monitor = None
        try:
            os.environ.update(settings)
            head_gpus = _status_total(_cli(["status"], env, tmp), "GPU")
            ctx = ray_tpu_torch.init(address=gcs)
            url = ctx.dashboard_url
            version = _http_json(url + "/api/version")
            nodes0 = _http_json(url + "/api/nodes")
            status0 = _http_json(url + "/api/cluster_status")
            res["head"] = {"gcs": gcs, "dashboard_url": url, "cli_status_gpu": head_gpus,
                           "version": version, "nodes": len(nodes0),
                           "dashboard_gpu": status0["resources_total"].get("GPU", 0.0)}
            print(f"[operator] cli start --head --num-cpus 4 --num-gpus 0: cli status GPU "
                  f"{head_gpus}; dashboard {url}: /api/version {version}, /api/nodes "
                  f"{len(nodes0)} node(s), /api/cluster_status {status0['resources_total']}",
                  flush=True)
            if (head_gpus != 0.0 or version.get("version") != "ray_tpu_torch"
                    or len(nodes0) != 1 or res["head"]["dashboard_gpu"] != 0.0):
                raise AssertionError(f"the CLI's head or its dashboard: {res['head']}")

            worker = get_global_worker()
            provider = TimedProvider({"gcs_address": gcs, "session_dir": ctx["session_dir"]})
            scaler = StandardAutoscaler(provider, OPERATOR_NODE_TYPES, max_workers=1,
                                        idle_timeout_s=OPERATOR_IDLE_S,
                                        gcs_client=worker.gcs_client)
            monitor = Monitor(scaler, interval_s=0.5)
            monitor.start()

            job_dir = os.path.join(tmp, "job")
            os.makedirs(job_dir)
            script = os.path.join(job_dir, "job.py")
            with open(script, "w") as f:
                f.write(_JOB_SCRIPT)
            entry = " ".join([sys.executable, script, os.path.join(tmp, "workflows"), job_dir,
                              OPERATOR_WORKFLOW, OPERATOR_MARK,
                              *(str(x) for x in (CLIENT_B, CLIENT_T, CLIENT_SEED,
                                                 PROMPT_VOCAB, 200))])
            client = JobSubmissionClient(url)
            mark_value = f"runtime_env of {os.getpid()}"
            t_submit = time.perf_counter()
            sid = client.submit_job(entrypoint=entry,
                                    runtime_env={"env_vars": {OPERATOR_MARK: mark_value}})
            job_status = client.wait_until_finished(sid, timeout=600, poll_s=0.1)
            t_done = time.perf_counter()
            logs = client.get_job_logs(sid)
            if job_status != "SUCCEEDED":
                raise AssertionError(f"the job ended {job_status}: {logs[-4000:]}")
            line = [ln for ln in logs.splitlines() if ln.startswith("JOB_RESULT ")]
            if not line:
                raise AssertionError(f"the job printed no result: {logs[-4000:]}")
            job = json.loads(line[-1][len("JOB_RESULT "):])
            got = np.load(os.path.join(job_dir, "job.npz"))

            # the GPU node: launched once, ready, then drained and terminated
            _await("the idle GPU node was never terminated",
                   lambda: scaler.num_terminations and not provider.non_terminated_nodes({}),
                   timeout_s=60)
            t_gone = time.perf_counter()

            def gpu_back():
                gpu = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
                dash = _http_json(url + "/api/cluster_status")["resources_total"].get("GPU", 0.0)
                return (gpu, dash) if gpu == 0.0 and dash == 0.0 else None

            _await("the cluster's GPU did not go back to 0", gpu_back, timeout_s=30, period_s=0.2)
            job_info = _http_json(f"{url}/api/jobs/{sid}")
            events = state.list_tasks()
            steps = [t for t in events if t.get("name", "").endswith(".gpt2_last_logits")]
            step_ids = sorted({t.get("task_id") for t in steps})
            step_nodes = sorted({t.get("node_id") for t in steps})
            (launch_t0, launch_t1, launch_tags, launch_count), = marks["launches"]
            res["autoscaler"] = {"launches": scaler.num_launches, "drains": scaler.num_drains,
                                 "terminations": scaler.num_terminations,
                                 "launched": [(m[2], m[3]) for m in marks["launches"]],
                                 "submit_to_launch_s": launch_t0 - t_submit,
                                 "launch_to_ready_s": launch_t1 - launch_t0,
                                 "done_to_terminated_s": marks["terminations"][0][1] - t_done,
                                 "terminated_to_gpu_0_s": time.perf_counter() - t_gone}
            res["job"] = {**job, "submission_id": sid, "status": job_status,
                          "dashboard_status": job_info["status"], "wall_s": t_done - t_submit,
                          "gpu_step_task_ids": step_ids, "gpu_step_events": len(steps),
                          "gpu_step_event_nodes": step_nodes,
                          "task_events": sorted({(t.get("name"), t.get("state")) for t in events})}
            if inside is not None:
                # the operator's autoscaler stops first: phase 25 brings its own
                monitor.stop()
                monitor = None
                res["slice"] = inside(gcs, ctx["session_dir"])
        finally:
            if monitor is not None:
                monitor.stop()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            ray_tpu_torch.shutdown()
            stop_out = _cli(["stop"], env, tmp)
        res["processes_left"] = _wait_no_port_processes("operator")
        res["cli_stop"] = stop_out.strip()

    logits, ids = got["logits"], got["ids"]
    same = bool(np.array_equal(logits, want_logits) and np.array_equal(ids, want_ids))
    err = float(np.abs(logits.astype(np.float64) - want_logits).max())
    resumed = bool(np.array_equal(got["resumed_logits"], logits)
                   and np.array_equal(got["resumed_ids"], ids))
    want_launches = job["n_layer"]
    a = res["autoscaler"]
    res.update(same_as_phase_15c=same, max_abs_diff=err, resumed_same=resumed,
               launches=job["launches"], seconds=time.perf_counter() - t0)
    print(f"[operator] job {sid} (driver pid {job['pid']}, no torch: libtorch {job['libtorch']}, "
          f"libcuda {job['libcuda']}) {job_status} in {res['job']['wall_s']:.2f} s, workflow "
          f"{job['workflow_status']}: GPU step on node {job['step_node'][:12]} ({job['step_device']}, pid "
          f"{job['step_pid']}, {job['step_s']:.2f} s), argmax on node {job['argmax_node'][:12]} "
          f"(torch imported {job['argmax_torch']}); logits equal to phase 15 (c)'s forward of "
          f"batch 0 bit for bit {same} (max |diff| {err:.3e}), ids equal too; B1 launches in "
          f"the step {job['launches']} (want {want_launches}); the runtime_env's "
          f"{OPERATOR_MARK} seen in the step {job['mark'] == mark_value}; resume returned the "
          f"same output {resumed}, the GPU step's task ids {step_ids} — {card}", flush=True)
    print(f"[operator] autoscaler: launches {a['launches']} {a['launched']}, "
          f"{a['submit_to_launch_s']:.2f} s from submit to launch, launch to ready "
          f"{a['launch_to_ready_s']:.2f} s, drains {a['drains']}, terminations "
          f"{a['terminations']}, job done to node terminated {a['done_to_terminated_s']:.2f} s, "
          f"then GPU 0 in the cluster and the dashboard after "
          f"{a['terminated_to_gpu_0_s']:.2f} s; /api/jobs/{sid} {res['job']['dashboard_status']}; "
          f"cli stop: {res['cli_stop']!r}, port processes left {sorted(res['processes_left'])}; "
          f"phase {res['seconds']:.1f} s — {card}", flush=True)
    if not same or err != 0.0:
        raise AssertionError(f"the workflow's logits differ from phase 15 (c)'s: {err}")
    if job["launches"] != want_launches:
        raise AssertionError(f"the GPU step launched B1 {job['launches']} times, "
                             f"want {want_launches}")
    if job["mark"] != mark_value:
        raise AssertionError(f"the job's runtime_env did not reach its step: {job['mark']!r}")
    if job["libtorch"] or job["libcuda"] or job["torch_imported"] or job["argmax_torch"]:
        raise AssertionError(f"the job's driver or its CPU step loaded torch: {job}")
    if job["step_node"] == job["argmax_node"]:
        raise AssertionError("the GPU step ran on the head, which has no GPU")
    if (not resumed or job["workflow_status"] != "SUCCESSFUL" or len(step_ids) != 1
            or step_nodes != [job["step_node"]]):
        raise AssertionError(f"resume re-ran the GPU step or changed the output: {step_ids}, "
                             f"task events {res['job']['task_events']}")
    if (a["launches"] != 1 or a["launched"] != [({"node-kind": "worker",
                                                   "node-type": "gpu_worker"}, 1)]
            or a["drains"] != 1 or a["terminations"] != 1):
        raise AssertionError(f"the autoscaler did not launch, drain and terminate one "
                             f"gpu_worker node: {a}")
    if res["job"]["dashboard_status"] != "SUCCEEDED":
        raise AssertionError(f"/api/jobs/{sid}: {res['job']['dashboard_status']}")
    print("[operator] " + json.dumps(res, default=str), flush=True)
    return res


# ----------------------------------------------------------------------
# Phase 25: a GPU slice that AutoscalerV2 brings up through GPUNodeProvider
# in phase 23's head, runs GPT-2 small on, and frees again
# ----------------------------------------------------------------------
SLICE_TYPE = "h100-1"
SLICE_NODE_TYPES = {"gpu_slice": {"resources": {"CPU": 4, "GPU": 1,
                                                f"GPU-{SLICE_TYPE}-head": 1},
                                  "node_config": {"accelerator_type": SLICE_TYPE}}}
SLICE_IDLE_S = 1.0  # the autoscaler's idle timeout for the slice
SLICE_TICK_S = 0.2  # this process drives AutoscalerV2.update() at this period


def gpt2_slice_logits(tokens, seed):
    """Phase 23's workflow step as a task on the slice's node: GPT-2 small
    f32 from ``seed`` on the card, the last position's logits of
    ``tokens`` (pickled by value: a function of ``__main__``)."""
    t_start = time.perf_counter()
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2.GPT2Config.small(dtype=torch.float32, remat=False)
    model = gpt2.init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
    model = model.to("cuda").eval()
    before = fa.flash_attention_fwd.launches
    with torch.inference_mode():
        logits = model(torch.from_numpy(tokens).to("cuda"))[:, -1].cpu().numpy()
    return {"logits": logits, "launches": fa.flash_attention_fwd.launches - before,
            "n_layer": cfg.n_layer, "pid": os.getpid(),
            "node": ray_tpu_torch.get_runtime_context().get_node_id(),
            "device": torch.cuda.get_device_name(0), "step_s": time.perf_counter() - t_start}


def phase_gpu_slice(card: str, gcs: str, session_dir: str, runtime: dict) -> dict:
    """(25 b) In the head of phase 23 (no GPU of its own): AutoscalerV2
    over GPUNodeProvider with MockGpuClient and launch_local_raylets, one
    node type of slice type h100-1; a task that asks for the slice's head
    resource and one GPU runs phase 23's GPT-2 small f32 step; the slice
    then idles out.  This process drives ``update()`` every SLICE_TICK_S."""
    from ray_tpu_torch._private.worker import get_global_worker
    from ray_tpu_torch.autoscaler import GPUNodeProvider, MockGpuClient
    from ray_tpu_torch.autoscaler.v2 import AutoscalerV2

    t0 = time.perf_counter()
    want_logits, want_ids = runtime["client_batch0"]
    marks = {"launches": [], "terminations": []}

    class TimedProvider(GPUNodeProvider):
        """The GPU-slice provider, with the times of its launches and
        terminations."""

        def create_node(self, node_config, tags, count):
            marks["launches"].append(time.perf_counter())
            return super().create_node(node_config, tags, count)

        def terminate_node(self, node_id):
            marks["terminations"].append(time.perf_counter())
            super().terminate_node(node_id)

    client = MockGpuClient()
    provider = TimedProvider({"gpu_client": client, "launch_local_raylets": True,
                              "gcs_address": gcs, "session_dir": session_dir},
                             cluster_name="chip")
    worker = get_global_worker()
    scaler = AutoscalerV2(provider, SLICE_NODE_TYPES, max_workers=1,
                          idle_timeout_s=SLICE_IDLE_S, gcs_client=worker.gcs_client)
    head_node = worker.node_id.hex()
    step = ray_tpu_torch.remote(num_gpus=1, resources={f"GPU-{SLICE_TYPE}-head": 1})(
        gpt2_slice_logits)
    tokens = np.random.default_rng(200).integers(0, PROMPT_VOCAB, size=(CLIENT_B, CLIENT_T))
    t_submit = time.perf_counter()
    ref = step.remote(tokens, CLIENT_SEED)
    t_ready = t_running = None
    deadline = time.monotonic() + 120
    while True:
        scaler.update()
        nodes = provider.non_terminated_nodes({})
        if t_ready is None and nodes and provider.node_tags(nodes[0])["node-status"] == "up-to-date":
            t_ready = time.perf_counter()
        if t_running is None and scaler.status()["counts"].get("RAY_RUNNING", 0):
            t_running = time.perf_counter()
        done, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=SLICE_TICK_S)
        if done:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 25: the slice's step did not finish: "
                                 f"{scaler.status()}")
    out = ray_tpu_torch.get(ref)
    t_result = time.perf_counter()
    (slice_name,) = [s["name"] for s in client.list()]
    during = {k: v for k, v in ray_tpu_torch.cluster_resources().items() if k.startswith(("GPU", "gpu"))}
    # the slice idles out: drained, terminated, deleted from the API
    deadline = time.monotonic() + 60
    while provider.non_terminated_nodes({}) or client.list():
        scaler.update()
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 25: the idle slice was never terminated: "
                                 f"{scaler.status()}, {client.list()}")
        time.sleep(SLICE_TICK_S)
    t_gone = time.perf_counter()

    def slice_resources_gone():
        left = {k: v for k, v in ray_tpu_torch.cluster_resources().items()
                if k.startswith(("GPU", "gpu")) and v}
        return {"left": left} if not left else None

    _await("the slice's GPU resources did not leave the cluster", slice_resources_gone,
           timeout_s=30, period_s=SLICE_TICK_S)
    t_free = time.perf_counter()
    logits = out["logits"]
    ids = logits.argmax(-1)
    same = bool(np.array_equal(logits, want_logits) and np.array_equal(ids, want_ids))
    err = float(np.abs(logits.astype(np.float64) - want_logits).max())
    res = {"slice": slice_name, "type": SLICE_TYPE, "during": during,
           "launches": len(marks["launches"]), "terminations": len(marks["terminations"]),
           "counts": scaler.status()["counts"], "same_as_phase_15c": same, "max_abs_diff": err,
           "b1_launches": out["launches"], "n_layer": out["n_layer"], "step_node": out["node"],
           "head_node": head_node, "step_device": out["device"], "step_pid": out["pid"],
           "step_s": out["step_s"],
           "submit_to_launch_s": marks["launches"][0] - t_submit if marks["launches"] else None,
           "launch_to_ready_s": (t_ready - marks["launches"][0]) if t_ready else None,
           "ready_to_ray_running_s": (t_running - t_ready) if t_running and t_ready else None,
           "submit_to_result_s": t_result - t_submit,
           "result_to_terminated_s": (marks["terminations"][0] - t_result
                                      if marks["terminations"] else None),
           "terminated_to_gone_s": t_gone - marks["terminations"][0] if marks["terminations"] else None,
           "gone_to_gpu_0_s": t_free - t_gone}
    res["seconds"] = time.perf_counter() - t0

    def _s(x):
        return "n/a" if x is None else f"{x:.2f} s"

    print(f"[gpu slice] AutoscalerV2 over GPUNodeProvider (MockGpuClient, "
          f"launch_local_raylets): slice {slice_name} of type {SLICE_TYPE} launched "
          f"{res['launches']} time(s), {_s(res['submit_to_launch_s'])} from submit to launch, "
          f"launch to ready (the slice's raylet up) {_s(res['launch_to_ready_s'])}, ready to "
          f"RAY_RUNNING {_s(res['ready_to_ray_running_s'])}; the cluster's GPU resources with "
          f"the slice {during}; the step on node {out['node'][:12]} (the head is "
          f"{head_node[:12]}), {out['device']}, pid {out['pid']}, {out['step_s']:.2f} s; submit "
          f"to first result {res['submit_to_result_s']:.2f} s; logits equal to phase 15 (c)'s "
          f"bit for bit {same} (max |diff| {err:.3e}), B1 launches {out['launches']} (want "
          f"{out['n_layer']}); result to terminated {_s(res['result_to_terminated_s'])}, "
          f"deleted from the API and terminated {res['terminations']} time(s), GPU 0 again "
          f"{res['gone_to_gpu_0_s']:.2f} s later; states {res['counts']}; phase "
          f"{res['seconds']:.1f} s — {card}", flush=True)
    if not same or err != 0.0:
        raise AssertionError(f"phase 25: the slice's logits differ from phase 15 (c)'s: {err}")
    if out["launches"] != out["n_layer"]:
        raise AssertionError(f"phase 25: B1 launched {out['launches']} times in the step, "
                             f"want {out['n_layer']}")
    if out["node"] == head_node or out["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"phase 25: the step ran on {out['node']} ({out['device']}), "
                             f"not on the slice's node")
    if (res["launches"] != 1 or res["terminations"] != 1
            or during.get("GPU") != 1.0 or during.get(f"GPU-{SLICE_TYPE}-head") != 1.0
            or during.get(f"gpu-slice:{slice_name}") != 1.0):
        raise AssertionError(f"phase 25: one slice launched, registered and terminated: {res}")
    print("[gpu slice] " + json.dumps(res, default=str), flush=True)
    return res


# ----------------------------------------------------------------------
# Preemption: (a) a drained GPU worker's fit() resumes exactly on the other
# node, (b) a card actor rides out a GCS restart
# ----------------------------------------------------------------------
# (a): phase 9's run cut to 8 steps; the periodic checkpoint at step 3, the
# drain once step 5 is reported.  A step takes at least PREEMPT_MIN_STEP_S
# (the reference's drill sleeps its steps), so the notice lands in the
# loop before its last step: three steps of margin.
PREEMPT_STEPS, PREEMPT_PERIODIC, PREEMPT_DRAIN_AT = 8, 3, 5
PREEMPT_MIN_STEP_S = 0.5
PREEMPT_DEADLINE_S = 60  # the drain notice's deadline, as the reference's drill gives it


def _preempted_fit(card: str, raw: dict, cfg, device: str) -> dict:
    """(a) TorchTrainer's drain-aware GPT-2 loop on one GPU worker of a
    cluster with two GPU nodes (both count the machine's one card: the
    restarted rank shares it with nothing, its predecessor gone), drained
    once under the rank; the run resumes on the other node."""
    import threading

    from ray_tpu_torch._private.worker import get_global_worker
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.train import FailureConfig
    from ray_tpu_torch.util import state

    t0 = time.perf_counter()
    toks = np.random.default_rng(4).integers(0, PROMPT_VOCAB, size=(TRAIN_B, TRAIN_T + 1))
    want = (cfg.n_layer if device == "cuda" else 0,) * 3  # a CPU tensor takes the plain path
    saved = os.environ.get("RAY_TPU_TORCH_arena_prefault_bytes")
    os.environ["RAY_TPU_TORCH_arena_prefault_bytes"] = "0"
    cluster = None
    res = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_preempt_") as tmp:
        progress = os.path.join(tmp, "progress.jsonl")
        ckpt_dirs = set(os.listdir(tempfile.gettempdir()))
        try:
            cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1, "num_gpus": 0})
            handles = [cluster.add_node(num_cpus=2, num_gpus=1) for _ in range(2)]
            cluster.wait_for_nodes()
            ray_tpu_torch.init(address=cluster.address)
            gcs = get_global_worker().gcs_client
            drains, stop = [], threading.Event()

            def drainer():
                """Drain the node that hosts the rank once step >= 5 is reported."""
                while not stop.is_set():
                    try:
                        with open(progress) as f:
                            last = json.loads(f.read().splitlines()[-1])
                    except (OSError, ValueError, IndexError):  # not written yet, or mid-line
                        last = None
                    if last is not None and last["step"] >= PREEMPT_DRAIN_AT:
                        t = time.time()
                        reply = gcs.call("drain_node", {
                            "node_id": bytes.fromhex(last["node_id"]), "reason": "PREEMPTION",
                            "deadline_s": PREEMPT_DEADLINE_S})
                        drains.append({"node_id": last["node_id"], "at_step": last["step"],
                                       "t": t, "reply": reply})
                        return
                    time.sleep(0.02)

            thread = threading.Thread(target=drainer, daemon=True, name="chip-smoke-drainer")
            thread.start()
            t_fit = time.perf_counter()
            try:
                result = TorchTrainer(
                    train_loop_per_worker,
                    train_loop_config={
                        "cfg": cfg, "seed": 0, "tokens": toks, "lr": TRAIN_LR, "warmup": 0,
                        "steps": PREEMPT_STEPS, "device": device,
                        "drain_aware": {"periodic_step": PREEMPT_PERIODIC, "progress": progress,
                                        "min_step_s": PREEMPT_MIN_STEP_S}},
                    scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                    run_config=RunConfig(name="preempted_fit", storage_path=tmp,
                                         failure_config=FailureConfig(max_failures=0)),
                ).fit()
            finally:
                stop.set()
                thread.join(timeout=10)
            fit_s = time.perf_counter() - t_fit
            with open(progress) as f:
                records = [json.loads(line) for line in f.read().splitlines()]
            # each persisted checkpoint's commit: its manifest's mtime
            commits = sorted(
                os.path.getmtime(os.path.join(root, "MANIFEST.json"))
                for root, _, files in os.walk(tmp) if "MANIFEST.json" in files)
            drained = [n for n in state.list_nodes() if n.get("drain_reason") == "PREEMPTION"]
            # the preempted machine goes away; then the card's GPU is free again
            if len(drains) == 1:
                victim = [h for h in handles if h.raylet_address == next(
                    n["raylet_address"] for n in state.list_nodes()
                    if n["node_id"] == drains[0]["node_id"])]
                cluster.remove_node(victim[0])
            deadline, gpu = time.monotonic() + 30, None
            while time.monotonic() < deadline:
                gpu = (ray_tpu_torch.available_resources().get("GPU", 0.0),
                       ray_tpu_torch.cluster_resources().get("GPU", 0.0))
                if gpu == (1.0, 1.0):
                    break
                time.sleep(0.1)
        finally:
            ray_tpu_torch.shutdown()
            if cluster is not None:
                cluster.shutdown()
            if saved is None:
                os.environ.pop("RAY_TPU_TORCH_arena_prefault_bytes", None)
            else:
                os.environ["RAY_TPU_TORCH_arena_prefault_bytes"] = saved
            # the loop's host snapshots (Checkpoint.from_pytree's temp dirs)
            for name in set(os.listdir(tempfile.gettempdir())) - ckpt_dirs:
                if name.startswith("ray_tpu_torch_ckpt_"):
                    shutil.rmtree(os.path.join(tempfile.gettempdir(), name), ignore_errors=True)

    m = result.metrics
    first = [r for r in records if r["resumed_from"] < 0]
    second = [r for r in records if r["resumed_from"] >= 0]
    losses = [(r["step"], r["loss"]) for r in records]
    rels = [abs(r["loss"] - raw["losses"][r["step"] - 1]) / abs(raw["losses"][r["step"] - 1])
            for r in records]
    notice = drains[0] if drains else {}
    drain_ckpt = [r for r in first if r.get("checkpoint") == "drain"]
    res.update(
        drains=drains, drained_nodes=[n["node_id"] for n in drained], metrics=m,
        first_attempt=[(r["step"], r["node_id"][:12], r["pid"]) for r in first],
        resumed_attempt=[(r["step"], r["node_id"][:12], r["pid"]) for r in second],
        losses=losses, max_loss_rel_err_vs_phase9=max(rels) if rels else None,
        launches_per_step=sorted({tuple(r["launches"]) for r in records}),
        launches=dict(zip(("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"),
                          (sum(r["launches"][i] for r in records) for i in range(3)))),
        checkpoints=[(r["step"], r["checkpoint"], r["checkpoint_bytes"])
                     for r in records if r.get("checkpoint")],
        gpu_after=gpu, fit_s=fit_s)
    if drain_ckpt and notice:
        res["notice_to_checkpoint_s"] = drain_ckpt[0]["saved"] - notice["t"]
        res["checkpoint_bytes"] = drain_ckpt[0]["checkpoint_bytes"]
        # the drain's persist is synchronous, after any write still in flight
        res["notice_to_commit_s"] = next(
            (c - notice["t"] for c in commits if c > drain_ckpt[0]["saved"]), None)
    if second and notice:
        res["notice_to_resumed_step_s"] = second[0]["done"] - notice["t"]
        res["resume_load_s"] = second[0]["load_s"]
        # the restarted worker's start, split: its loop began (the process
        # spawned, torch imported while the config unpickled), the model's
        # modules imported, a CUDA context, the model and AdamW built, the
        # checkpoint loaded, the first step done
        tl = second[0]["timeline"]
        marks = [("loop", tl["loop"]), ("imports", tl["imports"]), ("device", tl["device"]),
                 ("model", tl["model"]), ("loaded", tl["loaded"]), ("step", second[0]["done"])]
        res["resumed_start_s"] = {"notice_to_loop": tl["loop"] - notice["t"], **{
            f"{a}_to_{b}": tb - ta for (a, ta), (b, tb) in zip(marks, marks[1:])}}
    res["seconds"] = time.perf_counter() - t0
    print(f"[preemption] (a) TorchTrainer.fit() of the drain-aware GPT-2 loop (phase 9's "
          f"configuration, {PREEMPT_STEPS} steps, max_failures=0) on {device}: drains "
          f"{[(d['node_id'][:12], d['at_step']) for d in drains]}; first attempt (step, node, "
          f"pid) {res['first_attempt']}, resumed {res['resumed_attempt']}; checkpoints (step, "
          f"kind, bytes) {res['checkpoints']}; result step {m.get('step')} resumed_from "
          f"{m.get('resumed_from')}; launches a step B1/B2/B3 {res['launches_per_step']} (want "
          f"{want}); losses vs phase 9's max rel {res['max_loss_rel_err_vs_phase9']} (tol 1e-5); "
          f"notice to checkpoint written {res.get('notice_to_checkpoint_s')} s, committed to "
          f"the run's storage {res.get('notice_to_commit_s')} s, to the first resumed step "
          f"{res.get('notice_to_resumed_step_s')} s (its load {res.get('resume_load_s')} s; the "
          f"restarted worker's start {res.get('resumed_start_s')}); GPU (available, total) "
          f"after {gpu}; fit "
          f"{fit_s:.1f} s, (a) {res['seconds']:.1f} s — {card}", flush=True)
    if len(drains) != 1 or len(drained) != 1 or not drains[0]["reply"].get("accepted"):
        raise AssertionError(f"want exactly one accepted drain: {drains}, drained {drained}")
    if m.get("step") != PREEMPT_STEPS or m.get("resumed_from", -1) < PREEMPT_DRAIN_AT:
        raise AssertionError(f"the run did not resume after the periodic checkpoint: {m}")
    if not drain_ckpt or [r["step"] for r in second] != list(
            range(m["resumed_from"] + 1, PREEMPT_STEPS + 1)):
        raise AssertionError(f"no drain checkpoint, or the resumed steps do not follow it: "
                             f"{records}")
    if ({r["node_id"] for r in first} != {notice["node_id"]}
            or {r["node_id"] for r in second} & {notice["node_id"]}):
        raise AssertionError(f"the restarted rank did not move to the other node: {records}")
    if [r["step"] for r in first][:PREEMPT_DRAIN_AT] != list(range(1, PREEMPT_DRAIN_AT + 1)):
        raise AssertionError(f"the first attempt's steps: {res['first_attempt']}")
    if res["launches_per_step"] != [want]:
        raise AssertionError(f"launches a step {res['launches_per_step']}, want {want}")
    # the weights, AdamW's moments and its step count, and the batch, as
    # phase 9's run had them at that step: every loss is that step's
    if max(rels) > 1e-5:
        raise AssertionError(f"losses {losses} differ from phase 9's {raw['losses']}")
    if gpu != (1.0, 1.0):
        raise AssertionError(f"the GPU is not free after fit(): (available, total) {gpu}")
    return res


# (b): the GCS drill's driver, a process of its own (a driver joins one
# cluster, and (a)'s is up meanwhile): it imports the port and numpy, never
# torch; its actor (defined here, so pickled by value) imports torch in its
# own process.
_GCS_RESTART_SCRIPT = r"""
import json, os, shutil, subprocess, sys, threading, time

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private import node as node_mod
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.worker import get_global_worker

out_dir, device, cfg = sys.argv[1], sys.argv[2], json.loads(sys.argv[7])
B, T, SEED, VOCAB = (int(x) for x in sys.argv[3:7])
t0 = time.perf_counter()


@ray_tpu_torch.remote(num_gpus=1)
class GCSRestartActor:
    # GPT-2 f32 from a seed, built on the CPU and moved to its device as
    # phase 15 (c)'s driver builds it

    def __init__(self, seed, cfg, device):
        import torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.train.torch.gpt2_loop import model_config

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = gpt2.init_model(model_config(cfg), torch.Generator().manual_seed(seed),
                                device="cpu")
        self.model, self.device = model.to(device).eval(), device

    def forward(self, tokens):
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        before = fa.flash_attention_fwd.launches
        with torch.inference_mode():
            logits = self.model(torch.from_numpy(tokens).to(self.device))[:, -1]
            ids = logits.argmax(-1)
        return {"logits": logits.cpu().numpy(), "ids": ids.cpu().numpy(),
                "launches": fa.flash_attention_fwd.launches - before, "pid": os.getpid()}


def spawn_gcs():
    # the port's GCS alone in a process, killable without its raylet
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.gcs_main", "--address", address,
         "--session-dir", session_dir, "--config", CONFIG.dump()],
        env=node_mod.child_env(), start_new_session=True)


tokens = np.random.default_rng(200).integers(0, VOCAB, size=(B, T))
session_dir = node_mod.new_session_dir()
address = f"unix:{session_dir}/sockets/gcs.sock"
procs = {"gcs": spawn_gcs()}
res, blocked = {}, {}
try:
    procs["raylet"], _ = node_mod.start_worker_node(address, session_dir, num_cpus=2,
                                                    num_gpus=1, wait=True)
    ray_tpu_torch.init(address=address)
    actor = GCSRestartActor.remote(SEED, cfg, device)
    answers = [ray_tpu_torch.get(actor.forward.remote(tokens), timeout=300)]
    t_ready = time.perf_counter()
    time.sleep(1.0)  # the GCS's snapshot loop (every 0.5 s) persists the actor

    procs["gcs"].kill()  # hard: no shutdown path runs
    procs["gcs"].wait(timeout=10)
    t_kill = time.perf_counter()
    answers.append(ray_tpu_torch.get(actor.forward.remote(tokens), timeout=60))

    def new_function():
        @ray_tpu_torch.remote
        def triple(x):
            return x * 3

        blocked["value"] = ray_tpu_torch.get(triple.remote(7), timeout=90)
        blocked["t"] = time.perf_counter()

    thread = threading.Thread(target=new_function, daemon=True)
    thread.start()
    time.sleep(1.0)
    res["blocked_during_outage"] = "value" not in blocked
    procs["gcs2"] = spawn_gcs()  # the same session directory
    t_restart = time.perf_counter()
    thread.join(timeout=90)
    answers.append(ray_tpu_torch.get(actor.forward.remote(tokens), timeout=60))
    info = get_global_worker().gcs_client.call("get_actor_info", actor._actor_id.binary())
    ray_tpu_torch.kill(actor)
    deadline, gpu = time.monotonic() + 30, None
    while time.monotonic() < deadline:
        gpu = (ray_tpu_torch.available_resources().get("GPU", 0.0),
               ray_tpu_torch.cluster_resources().get("GPU", 0.0))
        if gpu == (1.0, 1.0):
            break
        time.sleep(0.1)
    # what a GPU still held after the kill would be: the actor's state in
    # the new GCS, and whether its process is still there
    after = get_global_worker().gcs_client.call("get_actor_info", actor._actor_id.binary())
    res["actor_state_after_kill"] = (after or {}).get("state")
    try:
        os.kill(answers[0]["pid"], 0)
        res["actor_pid_alive_after_kill"] = True
    except OSError:
        res["actor_pid_alive_after_kill"] = False
finally:
    ray_tpu_torch.shutdown()
    for name in ("gcs2", "gcs", "raylet"):
        p = procs.get(name)
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    shutil.rmtree(node_mod.default_store_root(os.path.basename(session_dir)),
                  ignore_errors=True)
np.savez(os.path.join(out_dir, "answers.npz"), logits=np.stack([a["logits"] for a in answers]),
         ids=np.stack([a["ids"] for a in answers]))
res.update(launches=[a["launches"] for a in answers], pids=[a["pid"] for a in answers],
           actor_state=(info or {}).get("state"), blocked_value=blocked.get("value"),
           ready_s=t_ready - t0, outage_s=t_restart - t_kill,
           restart_to_blocked_return_s=blocked["t"] - t_restart if "t" in blocked else None,
           gpu_after=gpu, torch_imported="torch" in sys.modules,
           seconds=time.perf_counter() - t0)
print("GCS_RESULT " + json.dumps(res), flush=True)
"""


def _gcs_restart_start(tmp: str, device: str, actor_cfg: dict) -> subprocess.Popen:
    """(b)'s driver in a subprocess, started while (a) runs."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "gcs_restart.py")
    with open(script, "w") as f:
        f.write(_GCS_RESTART_SCRIPT)
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAY_TPU_TORCH_")}
    env.update(PYTHONPATH=repo, RAY_TPU_TORCH_arena_prefault_bytes="0")
    return subprocess.Popen(
        [sys.executable, script, tmp, device,
         *(str(x) for x in (CLIENT_B, CLIENT_T, CLIENT_SEED, PROMPT_VOCAB)),
         json.dumps(actor_cfg)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _gcs_restart_finish(card: str, proc: subprocess.Popen, tmp: str, batch0: tuple,
                        want: int, device: str) -> dict:
    """(b) A GCS spawned alone and one raylet {"CPU": 2, "GPU": 1}; a
    num_gpus=1 actor holds GPT-2 small f32 from phase 15 (c)'s seed.  The
    GCS is killed; the actor answers during the outage; a new function's
    first call blocks until a new GCS on the same session directory is up;
    the actor answers again, the same process, ALIVE in the new GCS."""
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    line = [ln for ln in out.splitlines() if ln.startswith("GCS_RESULT ")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"(b)'s driver failed ({proc.returncode}): {out[-4000:]}")
    res = {"card": card, **json.loads(line[-1][len("GCS_RESULT "):])}
    got = np.load(os.path.join(tmp, "answers.npz"))
    want_logits, want_ids = batch0
    same = [bool(np.array_equal(got["logits"][i], want_logits)
                 and np.array_equal(got["ids"][i], want_ids)) for i in range(3)]
    res["answers_equal_phase_15c"] = same
    print(f"[preemption] (b) GCS killed under a num_gpus=1 actor (GPT-2 small f32 on {device}, "
          f"pids {res['pids']}, ready {res['ready_s']:.1f} s after its driver started): its "
          f"answers before, during and after the outage equal phase 15 (c)'s forward of batch 0 "
          f"bit for bit {same}, B1 launches {res['launches']} (want {want} each); a new "
          f"function's call blocked during the outage {res['blocked_during_outage']}, returned "
          f"{res['blocked_value']} {res['restart_to_blocked_return_s']} s after the restart; "
          f"outage {res['outage_s']:.2f} s; the actor {res['actor_state']} in the new GCS; GPU "
          f"(available, total) after it went {res['gpu_after']}; torch in its driver "
          f"{res['torch_imported']}; (b) {res['seconds']:.1f} s — {card}", flush=True)
    if not all(same) or res["launches"] != [want] * 3:
        raise AssertionError(f"the actor's answers across the GCS restart: {same}, launches "
                             f"{res['launches']}")
    if len(set(res["pids"])) != 1 or res["actor_state"] != "ALIVE":
        raise AssertionError(f"the actor did not survive the restart as one process: "
                             f"{res['pids']}, {res['actor_state']}")
    if not res["blocked_during_outage"] or res["blocked_value"] != 21:
        raise AssertionError(f"the new function's call: blocked {res['blocked_during_outage']}, "
                             f"returned {res['blocked_value']}")
    if res["gpu_after"] != [1.0, 1.0]:
        raise AssertionError(f"the GPU is not free after the actor: (available, total) "
                             f"{res['gpu_after']}; the actor {res['actor_state_after_kill']} "
                             f"in the GCS, its process alive {res['actor_pid_alive_after_kill']}")
    return res


def phase_preemption(card: str, raw: dict, runtime: dict, cfg=None, device: str = "cuda",
                     actor_cfg=None) -> dict:
    """(24) (a) a preempted fit() that resumes exactly and, beside it, (b) a
    GCS restart under a card actor.  ``raw`` is phase 9's result,
    ``runtime`` phase 15's (its (c) batch 0 forward); ``cfg`` (a
    GPT2Config) and ``actor_cfg`` (gpt2_loop.model_config's dict) default
    to phase 9's and phase 15 (c)'s GPT-2 small."""
    t0 = time.perf_counter()
    cfg = cfg or gpt2.GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.float32,
                                       remat=False)
    actor_cfg = actor_cfg or {"size": "small", "dtype": "float32", "remat": False}
    want = model_config(actor_cfg).n_layer if device == "cuda" else 0
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gcs_") as tmp:
        proc = _gcs_restart_start(tmp, device, actor_cfg)
        try:
            res["fit"] = _preempted_fit(card, raw, cfg, device)
            print(f"[timing] preemption (a) preempted fit: {res['fit']['seconds']:.1f} s",
                  flush=True)
        finally:
            res["gcs"] = _gcs_restart_finish(card, proc, tmp, runtime["client_batch0"], want,
                                             device)
    print(f"[timing] preemption (b) GCS restart, beside (a): {res['gcs']['seconds']:.1f} s",
          flush=True)
    res["processes_left"] = _wait_no_port_processes("preemption")
    res["seconds"] = time.perf_counter() - t0
    print(f"[preemption] phase {res['seconds']:.1f} s — {card}", flush=True)
    print("[preemption] " + json.dumps(res, default=str), flush=True)
    return res


def main() -> int:
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        """fn(*args), its wall time printed and kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[timing] {name}: {seconds[name]:.1f} s", flush=True)
        return out

    card = timed("device", phase_device)
    timed("build", phase_build)
    fwd_rec = timed("kernels", phase_kernels, card)
    train_recs = timed("bwd kernels", phase_bwd_kernels, card)
    timed("host cost", phase_host_cost, card)
    llama_recs = timed("llama kernels", phase_llama_kernels, card)
    timed("parity", phase_parity, card)
    serve = timed("serve", phase_serve, card)
    fwd_rec["launches"] = serve["flash_launches"]
    timed("profile", phase_profile, card)
    train_parity = timed("train parity", phase_train_parity, card)
    train = timed("train", phase_train, card)
    for rec in train_recs:
        rec["launches"] = train["launches"][rec["name"]]
    timed("llama parity", phase_llama_parity, card)
    llama_train = timed("llama train", phase_llama_train, card)
    for rec in llama_recs:
        rec["launches"] = llama_train["launches"][rec["name"]]
    timed("resnet", phase_resnet, card)
    timed("vit", phase_vit, card)
    timed("mlp", phase_mlp, card)
    timed("moe", phase_moe, card)
    runtime = timed("runtime", phase_runtime, card, train_parity, train)
    fwd_rec["in_client_pool_launches"] = sum(runtime["client"]["launches"])
    in_framework = dict(zip(("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"),
                            runtime["trainer"]["launches"]))
    for rec in train_recs:
        rec["in_framework_launches"] = in_framework[rec["name"]]
    plane = timed("serve plane", phase_serve_plane, card, serve)
    fwd_rec["in_replica_launches"] = plane["launches"]
    dataplane = timed("dataplane", phase_dataplane, card, serve, plane)
    fwd_rec["over_dataplane_launches"] = dataplane["launches"]
    static_rec = timed("static kernel", phase_static_kernel, card, plane["static_launches"])
    static_rec["in_dag_launches"] = dataplane["dag"]["launches"]
    data = timed("data", phase_data, card)
    sharded = timed("sharded", phase_sharded, card, data)
    pipeline = timed("pipeline", phase_pipeline, card, data)
    tune_rllib = timed("tune and rllib", phase_tune_rllib, card, train)
    timed("rllib rest", phase_rllib_rest, card)
    operator = timed("operator", phase_operator, card, runtime,
                     lambda gcs, session_dir: timed("gpu slice", phase_gpu_slice, card, gcs,
                                                    session_dir, runtime))
    seconds["operator"] -= seconds["gpu slice"]  # its [timing] line includes phase 25's
    fwd_rec["in_gpu_slice_launches"] = operator["slice"]["b1_launches"]
    fwd_rec["in_workflow_launches"] = operator["launches"]
    preemption = timed("preemption", phase_preemption, card, train, runtime)
    fwd_rec["in_gcs_restart_actor_launches"] = sum(preemption["gcs"]["launches"])
    for rec in train_recs:
        rec["in_preempted_fit_launches"] = preemption["fit"]["launches"][rec["name"]]
    sweep = tune_rllib["sweep"]["trials"]
    for i, rec in enumerate(train_recs):
        rec["in_tune_trial_launches"] = {str(lr): t["launches"][i] for lr, t in sweep.items()}
    print(f"[timing] every phase (s): {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
          f"the script {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [fwd_rec, static_rec, *train_recs, *llama_recs,
                                  *data["kernels"], *sharded["kernels"], *pipeline["kernels"]]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
