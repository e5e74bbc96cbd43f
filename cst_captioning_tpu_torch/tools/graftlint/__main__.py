import sys

from cst_captioning_tpu_torch.tools.graftlint.cli import main

# guarded: importing every module of the package (as the import probes do)
# must not run the lint and exit the importer
if __name__ == "__main__":
    sys.exit(main())
