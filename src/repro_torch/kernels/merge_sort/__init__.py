"""Blocked bitonic merge sort: sort_blocks, merge_pass, remop_sort, argsort_by_key."""
