"""`python -m viorb_tpu_torch ...`: the command line (`run.py`)."""

from viorb_tpu_torch.run import main

if __name__ == "__main__":
    main()
