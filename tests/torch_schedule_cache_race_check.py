"""Concurrent-writer loop for the port's schedule-cache race test
(``tests/test_torch_tuner.py``), as ``schedule_cache_race_check.py`` is
the reference's.

Each invocation puts ``count`` distinct entries (``<prefix>-<i>``) into the
shared cache file as fast as it can.  The test runs two of these at once
and asserts no entry was lost: ``ScheduleCache.put`` merges with the file
under an exclusive lock just before its atomic replace.

Usage: torch_schedule_cache_race_check.py <cache_path> <prefix> <count>
"""
import sys

from repro_torch.api.schedule_cache import ScheduleCache


def main():
    path, prefix, count = sys.argv[1], sys.argv[2], int(sys.argv[3])
    cache = ScheduleCache(path)
    for i in range(count):
        cache.put(f"{prefix}-{i}", {"par_time": i, "writer": prefix})
    print("DONE", prefix)


if __name__ == "__main__":
    main()
