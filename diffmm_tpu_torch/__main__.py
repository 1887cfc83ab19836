from diffmm_tpu_torch.cli import main
from diffmm_tpu_torch.parallel.mesh import shutdown_distributed

if __name__ == "__main__":
    try:
        code = main()
    finally:
        shutdown_distributed()
    raise SystemExit(code)
