"""The distribution layer of the port: logical-axis sharding rules
(``sharding``), one-process collectives over a device mesh
(``collectives``) and the int8 error-feedback gradient all-reduce
(``compression``)."""
