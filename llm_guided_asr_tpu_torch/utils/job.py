"""Job scheduler abstraction — the cmd.sh / {run,queue,slurm,ssh}.pl analog
(the port's own copy of llm_guided_asr_tpu/utils/job.py).

The reference drives every heavy stage through a unified array-job interface
(egs2/TEMPLATE/asr1/cmd.sh; utils/{run,queue,slurm}.pl):

    <cmd>.pl [--mem 4G] [--time 10:00] [--gpu 1] JOB=1:<nj> <log> <command...>

where the literal token ``JOB`` in the command and log path is replaced by
the array index, and backend-specific flags come from a conf file
(conf/{queue,slurm}.conf) mapping generic options to scheduler arguments.

Here the same contract is a Python API:

    runner = JobRunner("local")            # or "stdout" | "slurm" | "sge" | "ssh"
    rc = runner.run(cmd=["python", "-m", "...", "--part", "JOB"],
                    log="exp/log/decode.JOB.log", array=(1, nj),
                    options=JobOptions(mem="4G", num_threads=2))

Backends:
  local   subprocess array with bounded parallelism (--max-jobs-run),
          per-job log files (run.pl)
  stdout  local + tee to stdout (stdout.pl)
  slurm   sbatch --array submission built from a slurm.conf-style mapping
  sge     qsub -t submission (queue.pl)
  ssh     round-robin dispatch over hosts from ``~/.queue/machines`` analog

Cluster backends construct the exact submission argv from the conf file;
``build_only=True`` returns it without executing (testable without a
scheduler; submission requires the scheduler binary on PATH).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import time as _time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import logging

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class JobOptions:
    """Unified options (cmd.sh header: --time/--mem/--max-jobs-run/
    --num-threads/--gpu/--config)."""

    mem: Optional[str] = None
    time: Optional[str] = None
    num_threads: int = 1
    gpu: int = 0
    max_jobs_run: Optional[int] = None
    extra_env: Optional[Dict[str, str]] = None


def _substitute(tokens: Sequence[str], job: int) -> List[str]:
    return [t.replace("JOB", str(job)) for t in tokens]


class SchedulerConf:
    """Kaldi {queue,slurm}.conf parser: lines of

        command <argv ...>
        option <name>=* <flags with $0>
        option <name>=<value> <flags>
        default <name>=<value>
    """

    def __init__(self, text: str):
        self.command: List[str] = []
        self.options: Dict[str, str] = {}  # "mem=*" -> "--mem $0"
        self.defaults: Dict[str, str] = {}
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            kind, rest = line.split(None, 1)
            if kind == "command":
                self.command = rest.split()
            elif kind == "option":
                name, flags = (rest.split(None, 1) + [""])[:2]
                self.options[name] = flags
            elif kind == "default":
                name, val = rest.split("=", 1)
                self.defaults[name.strip()] = val.strip()

    def flags_for(self, name: str, value) -> List[str]:
        if value is None:
            return []
        exact = f"{name}={value}"
        if exact in self.options:
            return self.options[exact].split()
        wild = f"{name}=*"
        if wild in self.options:
            return [f.replace("$0", str(value)) for f in self.options[wild].split()]
        return []


_DEFAULT_SLURM_CONF = """\
command sbatch --export=ALL --wait
option mem=* --mem-per-cpu $0
option time=* --time $0
option num_threads=* --cpus-per-task $0
option gpu=0
option gpu=* --gres gpu:$0
"""

_DEFAULT_SGE_CONF = """\
command qsub -V -sync y -cwd -j y
option mem=* -l mem_free=$0,ram_free=$0
option time=* -l h_rt=$0
option num_threads=* -pe smp $0
option gpu=0
option gpu=* -l gpu=$0
"""


class JobRunner:
    def __init__(
        self,
        backend: str = "local",
        conf: Optional[str] = None,  # path to a {queue,slurm}.conf file
        hosts: Optional[Sequence[str]] = None,  # ssh backend
    ):
        if backend not in ("local", "stdout", "slurm", "sge", "ssh"):
            raise ValueError(
                f"unknown cmd backend {backend!r}; known: local, stdout, "
                "slurm, sge, ssh (cmd.sh cmd_backend)"
            )
        self.backend = backend
        self.hosts = list(hosts or [])
        if conf is not None:
            self.conf = SchedulerConf(Path(conf).read_text())
        elif backend == "slurm":
            self.conf = SchedulerConf(_DEFAULT_SLURM_CONF)
        elif backend == "sge":
            self.conf = SchedulerConf(_DEFAULT_SGE_CONF)
        else:
            self.conf = None

    # ------------------------------------------------------------------
    def run(
        self,
        cmd: Sequence[str],
        log: str,
        array: Optional[Tuple[int, int]] = None,
        options: Optional[JobOptions] = None,
        build_only: bool = False,
    ):
        """Run (or, with build_only, construct) an (array) job.

        Returns 0/first-nonzero rc for executing backends; for cluster
        backends with build_only=True returns the submission argv."""
        options = options or JobOptions()
        if array is not None and array[0] < 1:
            raise ValueError("array jobs must start at 1 (JOB=1:N)")
        if self.backend in ("local", "stdout"):
            return self._run_local(list(cmd), log, array, options)
        if self.backend in ("slurm", "sge"):
            argv = self._build_cluster(list(cmd), log, array, options)
            if build_only:
                return argv
            if shutil.which(argv[0]) is None:
                raise RuntimeError(
                    f"{self.backend} backend needs {argv[0]!r} on PATH "
                    "(constructed submission: " + " ".join(argv) + ")"
                )
            return subprocess.run(argv).returncode
        # ssh: round-robin jobs over hosts
        return self._run_ssh(list(cmd), log, array, options, build_only)

    # ------------------------------------------------------------------
    def _run_local(self, cmd, log, array, options: JobOptions):
        jobs = range(array[0], array[1] + 1) if array else [None]
        limit = options.max_jobs_run or os.cpu_count() or 1
        env = dict(os.environ)
        if options.extra_env:
            env.update(options.extra_env)
        if options.num_threads:
            env.setdefault("OMP_NUM_THREADS", str(options.num_threads))
        procs: List[Tuple[int, subprocess.Popen, object]] = []
        rcs: List[int] = []

        def _drain(block_all=False):
            while procs and (block_all or len(procs) >= limit):
                j, p, fh = procs.pop(0)
                rc = p.wait()
                fh.close()
                if rc != 0:
                    logger.error(f"job {j} failed rc={rc} (log: {fh.name})")
                rcs.append(rc)

        for j in jobs:
            jcmd = _substitute(cmd, j) if j is not None else list(cmd)
            jlog = Path(log.replace("JOB", str(j)) if j is not None else log)
            jlog.parent.mkdir(parents=True, exist_ok=True)
            fh = open(jlog, "wb")
            # run.pl writes the command and timing header into the log
            fh.write(("# " + " ".join(jcmd) + "\n# started at "
                      + _time.strftime("%c") + "\n").encode())
            fh.flush()
            if self.backend == "stdout":
                p = subprocess.Popen(jcmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, env=env)
                # tee: forward to our stdout while recording
                p = _TeePopen(p, fh)
            else:
                p = subprocess.Popen(jcmd, stdout=fh, stderr=subprocess.STDOUT,
                                     env=env)
            procs.append((j if j is not None else 0, p, fh))
            _drain()
        _drain(block_all=True)
        return next((rc for rc in rcs if rc != 0), 0)

    # ------------------------------------------------------------------
    def _build_cluster(self, cmd, log, array, options: JobOptions):
        argv = list(self.conf.command)
        for name, val in (("mem", options.mem), ("time", options.time),
                          ("num_threads", options.num_threads),
                          ("gpu", options.gpu)):
            argv += self.conf.flags_for(name, val)
        logp = log.replace("JOB", "%a" if self.backend == "slurm" else "$TASK_ID")
        if self.backend == "slurm":
            argv += ["--output", logp]
            if array:
                argv += ["--array", f"{array[0]}-{array[1]}"]
                if options.max_jobs_run:
                    argv[-1] += f"%{options.max_jobs_run}"
            # the payload script substitutes JOB from SLURM_ARRAY_TASK_ID
            payload = " ".join(
                t.replace("JOB", "${SLURM_ARRAY_TASK_ID}") for t in cmd
            )
            argv += ["--wrap", payload]
        else:  # sge
            argv += ["-o", logp]
            if array:
                argv += ["-t", f"{array[0]}-{array[1]}"]
                if options.max_jobs_run:
                    argv += ["-tc", str(options.max_jobs_run)]
            payload = " ".join(t.replace("JOB", "${SGE_TASK_ID}") for t in cmd)
            argv += ["-b", "y", "/bin/bash", "-c", payload]
        return argv

    # ------------------------------------------------------------------
    def _run_ssh(self, cmd, log, array, options: JobOptions, build_only):
        if not self.hosts:
            raise ValueError("ssh backend needs hosts=[...] (~/.queue/machines)")
        jobs = list(range(array[0], array[1] + 1)) if array else [None]
        argvs = []
        for i, j in enumerate(jobs):
            host = self.hosts[i % len(self.hosts)]
            jcmd = _substitute(cmd, j) if j is not None else list(cmd)
            argvs.append(["ssh", host, "--", *jcmd])
        if build_only:
            return argvs
        procs = []
        for argv, j in zip(argvs, jobs):
            jlog = Path(log.replace("JOB", str(j)) if j is not None else log)
            jlog.parent.mkdir(parents=True, exist_ok=True)
            fh = open(jlog, "wb")
            procs.append((subprocess.Popen(argv, stdout=fh,
                                           stderr=subprocess.STDOUT), fh))
        rcs = []
        for p, fh in procs:
            rcs.append(p.wait())
            fh.close()
        return next((rc for rc in rcs if rc != 0), 0)


class _TeePopen:
    """Minimal stdout tee for the stdout.pl backend."""

    def __init__(self, proc: subprocess.Popen, fh):
        self._proc = proc
        self._fh = fh

    def wait(self):
        for line in self._proc.stdout:
            self._fh.write(line)
            sys.stdout.buffer.write(line)
        sys.stdout.flush()
        return self._proc.wait()
