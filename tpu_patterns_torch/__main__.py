import os
import sys

if os.environ.get("_TPU_PATTERNS_TORCH_REPLICA") and __name__ == "__main__":
    # a replica child of serve --replicas (serve/replica.py): fd 1 is the
    # line-JSON protocol, claimed before torch (or a kernel load) can
    # print there; everything else goes to stderr
    _proto_fd = os.dup(1)
    os.dup2(2, 1)
    from tpu_patterns_torch.serve.replica import replica_main

    sys.exit(replica_main(_proto_fd))

from tpu_patterns_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
