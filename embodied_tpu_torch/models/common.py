"""Entry-point wiring shared by agent packages: config assembly from
configs.yaml presets and CLI flags with logdir templating, env
construction by task prefix with the standard wrapper stack (in the
torch-free envs/factory.py, re-exported here), the agent's config view,
the replay, stream and logger factories, and script dispatch.

A copy of embodied_tpu/models/common.py with the scripts and outputs the
port has: `train`, `train_eval`, `eval_only`, the actor-learner script
`parallel` and its role scripts `parallel_env`, `parallel_envs` and
`parallel_replay` (`pretrain` raises), and every env suite of the JAX
package.

On a process group (`torch.coordinator_address`, see parallel/setup.py)
every rank runs the script: `train`, `train_eval` and `eval_only` run
there. Rank 0 writes to the logdir and rank k (RANK) to its subdirectory
`rank<k>`, so no file has two writers. Under `torch.mock_devices: N` (N
> 1) with no coordinator, `run_script` starts N gloo ranks on this host,
each with batch_size / (d f) rows on a 'd,f,t' mesh, so the global batch
stays batch_size, as in the JAX package's one process with N virtual
devices.
"""

import multiprocessing
import os
import socket
from functools import partial as bind

import yaml

from .. import core, nn, parallel, run
from ..envs.factory import ENV_CTORS, make_env, wrap_env  # noqa: F401
from ..parallel import meshes
from ..parallel.setup import rank_device, share_cores, shutdown
from ..core import selectors as selectorlib
from ..core import streams as streamlib
from ..utils import (
    Config, Counter, Flags, JSONLOutput, Logger, Path, ScoreOutput,
    TensorBoardOutput, TerminalOutput, WandBOutput, timer, timestamp)

def assemble_config(configs_path, argv=None):
  with open(configs_path) as f:
    configs = yaml.safe_load(f)
  parsed, other = Flags(Config(configs=('defaults',))).parse_known(argv)
  config = Config(configs['defaults'])
  for name in parsed.configs:
    config = config.update(configs[name])
  config = Flags(config).parse(other)
  config = config.update(
      logdir=config.logdir.format(timestamp=timestamp()))
  if 'JOB_COMPLETION_INDEX' in os.environ:
    config = config.update(replica=int(os.environ['JOB_COMPLETION_INDEX']))
  return config


# The scripts that run on a process group: no other script's collectives
# would line up across ranks (their train calls follow wall clocks).
GROUP_SCRIPTS = ('train', 'train_eval', 'eval_only')


def run_script(config, make_agent_fn):
  ranks = int(config.torch.mock_devices)
  if ranks > 1 and not config.torch.coordinator_address:
    return spawn_ranks(config, make_agent_fn, ranks)
  if config.torch.coordinator_address:
    if config.script not in GROUP_SCRIPTS:
      raise NotImplementedError(
          f'Script {config.script} on a process group: the port runs '
          f'{", ".join(GROUP_SCRIPTS)} there')
    rank = int(os.environ.get('RANK', 0))
    if rank:  # Rank 0 writes the logdir, rank k its subdirectory.
      config = config.update(logdir=str(Path(config.logdir) / f'rank{rank}'))
  print('Replica:', config.replica, '/', config.replicas)
  logdir = Path(config.logdir)
  print('Logdir:', logdir)
  print('Run script:', config.script)
  if config.script == 'pretrain':
    # The JAX package hands run.pretrain make_stream, which needs a replay
    # that pretrain never gives it, and its configs name no dataset.
    # run.pretrain itself runs on a stream the caller gives.
    raise NotImplementedError(
        'Script pretrain from main has no source of offline batches; call '
        'run.pretrain with a make_stream that returns a data.BagSampler '
        '(data/bag.py) over a directory of BagWriter shards.')
  if not config.script.endswith(('_env', '_replay')):
    logdir.mkdir()
    config.save(logdir / 'config.yaml')
  timer.enable(config.logger.timer)

  args = Config(
      **dict(config.run),
      replica=config.replica,
      replicas=config.replicas,
      logdir=config.logdir,
      batch_size=config.batch_size,
      batch_length=config.batch_length,
      report_length=config.report_length,
      consec_train=config.consec_train,
      consec_report=config.consec_report,
      replay_context=config.replay_context,
  )
  if config.script == 'train':
    run.train(
        bind(make_agent_fn, config),
        bind(make_replay, config, 'replay'),
        bind(make_env, config),
        bind(make_stream, config),
        bind(make_logger, config),
        args)
  elif config.script == 'train_eval':
    run.train_eval(
        bind(make_agent_fn, config),
        bind(make_replay, config, 'replay'),
        bind(make_replay, config, 'eval_replay', 'eval'),
        bind(make_env, config),
        bind(make_env, config),
        bind(make_stream, config),
        bind(make_logger, config),
        args)
  elif config.script == 'eval_only':
    run.eval_only(
        bind(make_agent_fn, config),
        bind(make_env, config),
        bind(make_logger, config),
        args)
  elif config.script == 'parallel':
    run.parallel.combined(
        bind(make_agent_fn, config),
        bind(make_replay, config, 'replay'),
        bind(make_replay, config, 'replay_eval', 'eval'),
        bind(make_env, config),
        bind(make_env, config),
        bind(make_stream, config),
        bind(make_logger, config),
        args)
  elif config.script == 'parallel_env':
    is_eval = config.replica >= args.envs
    run.parallel.parallel_env(
        bind(make_env, config), config.replica, args, is_eval)
  elif config.script == 'parallel_envs':
    run.parallel.parallel_envs(
        bind(make_env, config), bind(make_env, config), args)
  elif config.script == 'parallel_replay':
    run.parallel.parallel_replay(
        bind(make_replay, config, 'replay'),
        bind(make_replay, config, 'replay_eval', 'eval'),
        bind(make_stream, config),
        args)
  else:
    raise NotImplementedError(config.script)
  if config.torch.coordinator_address:
    shutdown()


def spawn_ranks(config, make_agent_fn, ranks):
  """Run the script on `ranks` gloo ranks on this host, each a spawned
  process with batch_size / nbatch rows (nbatch: the mesh's ('d','f')
  size; ranks along 't' are replicas); returns when all have ended, and
  raises (ending the rest) when one fails."""
  d, f, _ = meshes.mesh_sizes(config.torch.mesh, ranks)
  if config.batch_size % (d * f):
    raise ValueError(f'batch_size {config.batch_size} does not divide over '
                     f'the {d} x {f} data ranks of torch.mesh')
  with socket.socket() as sock:
    sock.bind(('localhost', 0))
    port = sock.getsockname()[1]
  context = multiprocessing.get_context('spawn')
  procs = [context.Process(target=_run_rank, args=(
      config, make_agent_fn, rank, ranks, d * f, port))
      for rank in range(ranks)]
  for proc in procs:
    proc.start()
  try:
    while any(proc.is_alive() for proc in procs):
      if any(proc.exitcode for proc in procs):
        break
      procs[0].join(1)
  finally:
    for proc in procs:
      if proc.is_alive():
        proc.terminate()
      proc.join()
  failed = {rank: p.exitcode for rank, p in enumerate(procs) if p.exitcode}
  if failed:
    raise RuntimeError(f'Ranks failed with exit codes {failed}')


def _run_rank(config, make_agent_fn, rank, ranks, nbatch, port):
  os.environ.update(RANK=str(rank), WORLD_SIZE=str(ranks),
                    LOCAL_RANK=str(rank))
  share_cores(ranks)
  config = config.update({
      'batch_size': config.batch_size // nbatch,
      'torch.coordinator_address': f'localhost:{port}'})
  run_script(config, make_agent_fn)


def make_agent(config, model_cls, device=None):
  """The torch Agent of `model_cls` for `config`, on `device` (default:
  the config's torch.device, 'cuda'), or under `random_agent` the agent
  that acts at random. Raises without a card unless the device is the
  CPU. `parallel.setup` comes first: on a process group the agent is the
  rank's, on cuda:{LOCAL_RANK}."""
  tcfg = config.torch
  device = device or tcfg.device
  parallel.setup(
      device=device, compute_dtype=tcfg.compute_dtype,
      mock_devices=int(tcfg.mock_devices),
      expect_devices=int(tcfg.expect_devices),
      coordinator_address=tcfg.coordinator_address,
      debug=bool(tcfg.debug), deterministic=bool(tcfg.deterministic),
      transfer_guard=bool(tcfg.transfer_guard))
  obs_space, act_space = env_spaces(config)
  if config.random_agent:
    return core.RandomAgent(obs_space, act_space)
  device = parallel.agent.resolve_device(rank_device(device))
  acfg = agent_config(config)
  model = model_cls(obs_space, act_space, acfg,
                    cdtype=nn.DTYPES[config.torch.compute_dtype])
  return parallel.Agent(model, obs_space, act_space, acfg, device)


def agent_config(config):
  return Config(
      agent=dict(config.agent),
      logdir=config.logdir,
      seed=config.seed,
      torch=dict(config.torch),
      batch_size=config.batch_size,
      batch_length=config.batch_length,
      replay_context=config.replay_context,
      replay_size=float(config.replay.size) if 'replay' in config else 1e6,
      report_length=config.report_length,
      replica=config.replica,
      replicas=config.replicas,
  )


def env_spaces(config):
  env = make_env(config, 0)
  notlog = lambda k: not k.startswith('log/')
  obs_space = {k: v for k, v in env.obs_space.items() if notlog(k)}
  act_space = {k: v for k, v in env.act_space.items() if k != 'reset'}
  env.close()
  return obs_space, act_space


def make_logger(config):
  step = Counter()
  logdir = config.logdir
  multiplier = dict(config.env).get(
      config.task.split('_')[0], {}).get('repeat', 1)
  outputs = [TerminalOutput(config.logger.filter, 'Agent')]
  for output in config.logger.outputs:
    if output == 'jsonl':
      outputs.append(JSONLOutput(logdir, 'metrics.jsonl'))
      outputs.append(ScoreOutput(
          logdir, task=config.task, method=config.method, seed=config.seed))
    elif output == 'tensorboard':
      outputs.append(TensorBoardOutput(logdir, config.logger.fps))
    elif output == 'wandb':
      outputs.append(WandBOutput(logdir, name='/'.join(
          str(logdir).split('/')[-2:])))
    elif output == 'terminal':
      pass  # Always included above.
    elif output == 'scope':
      pass  # Metrics viewer not bundled; jsonl covers the data.
    else:
      raise NotImplementedError(output)
  return Logger(step, outputs, multiplier)


def make_replay(config, folder, mode='train'):
  batlen = config.batch_length if mode == 'train' else config.report_length
  consec = config.consec_train if mode == 'train' else config.consec_report
  capacity = config.replay.size if mode == 'train' else config.replay.size / 10
  length = consec * batlen + config.replay_context
  assert config.batch_size * length <= capacity

  directory = Path(config.logdir) / folder
  if config.replicas > 1:
    directory = directory / f'{config.replica:05}'
  kwargs = dict(
      length=length, capacity=int(capacity), online=config.replay.online,
      chunksize=config.replay.chunksize, directory=directory)

  fracs = dict(config.replay.fracs)
  if fracs.get('uniform', 1.0) < 1 and mode == 'train':
    prio = dict(config.replay.prio)
    kwargs['selector'] = selectorlib.Mixture(dict(
        uniform=selectorlib.Uniform(),
        priority=selectorlib.Prioritized(**prio),
        recency=selectorlib.Recency(config.replay.recexp),
    ), fracs)
  return core.Replay(**kwargs)


def make_stream(config, replay, mode):
  length = config.batch_length if mode == 'train' else config.report_length
  consec = config.consec_train if mode == 'train' else config.consec_report
  # Validate the Consec window contract here, on the main thread, with the
  # config knobs in the message.
  need = consec * length + config.replay_context
  if replay.length < need:
    raise ValueError(
        f"Stream '{mode}' needs sampled windows of consec*length+context="
        f"{consec}*{length}+{config.replay_context}={need} steps, but the "
        f"replay it draws from stores sequences of {replay.length}. "
        f"Decrease report_length/consec_report or increase "
        f"batch_length/consec_train.")
  fn = bind(replay.sample, config.batch_size, mode)
  stream = streamlib.Stateless(fn)
  stream = streamlib.Consec(
      stream,
      length=length,
      consec=consec,
      prefix=config.replay_context,
      strict=(mode == 'train'),
      contiguous=True)
  return stream
