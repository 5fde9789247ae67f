import os
import sys

if __name__ == "__main__":
    # protocol children: fd 1 is the line-JSON protocol, claimed before
    # torch (or a kernel load) can print there; everything else goes to
    # stderr.  Both are dispatched before the CLI is imported.
    if os.environ.get("_TPU_PATTERNS_TORCH_EXEC_WORKER"):
        # a warm worker of the sweep engine (exec/worker.py)
        _proto_fd = os.dup(1)
        os.dup2(2, 1)
        from tpu_patterns_torch.exec.worker import main as worker_main

        sys.exit(worker_main(_proto_fd))
    if os.environ.get("_TPU_PATTERNS_TORCH_REPLICA"):
        # a replica child of serve --replicas (serve/replica.py)
        _proto_fd = os.dup(1)
        os.dup2(2, 1)
        from tpu_patterns_torch.serve.replica import replica_main

        sys.exit(replica_main(_proto_fd))

from tpu_patterns_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
