"""The benchmark's own operation and byte counts, one module a kernel
family, each computed from a configuration file's widths and a traffic
mix's sizes: a share of a roofline reads the same work whatever
implements it."""
