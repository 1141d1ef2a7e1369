import sys

from ray_tpu_torch.devtools.lint.cli import main

# guarded (the reference's is not): importing every module of the port,
# as its isolation test does, must not run the linter and exit
if __name__ == "__main__":
    sys.exit(main())
