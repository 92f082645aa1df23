import sys

from .render import main

sys.exit(main())
