"""Native (C++) host components: the recordio reader/writer, the
prefetch loader and the pinned host arena. Built with g++ at first use
(``loader``); Python fallbacks keep the CPU path working without it."""
from . import loader  # noqa
